"""The XLS-R 300M embedding model in plain PyTorch, written from the
published description, with no kernel, cache or CUDA graph of the program.

- Input: a 16 kHz waveform a clip, int16 / 32768, normalized to zero mean
  and unit variance (``do_normalize``: the biased variance plus 1e-7),
  computed here in float64 and rounded to float32 (``normalize``).
- Feature encoder (wav2vec 2.0, arXiv:2006.11477, as XLS-R,
  arXiv:2111.09296, configures it, ``feat_extract_norm`` "layer"): 7
  convolutions with bias, each followed by LayerNorm over its channels and
  erf GELU.
- Feature projection: LayerNorm, then a dense layer to the hidden width.
- Positional convolution: grouped, padding kernel // 2, the last frame
  dropped for an even kernel, under weight norm over dim 2 written out
  (w = g v / ||v||, the norm over the other dims), erf GELU; added to the
  projected features.
- Transformer (``do_stable_layer_norm``): pre-LN layers, x + Attn(LN(x))
  with the softmax written out (exp(s - max) / sum) over heads of
  softmax(QK^T / sqrt(head size))V, then x + FF(LN(x)) with an erf GELU
  between two dense layers; a final LayerNorm.
- Embedding head (train_monolingual_embedding.py:81-100 of
  harvard-edge/multilingual_kws): the mean over the frames, Dense 1024 relu,
  Dense 1024 relu, Dense 192 selu; then Dense ``num_labels`` logits.

Departures from the published model, which the benchmark's configuration
lists as assumed: no dropout (0.1 in the published configuration), no
layerdrop (0.1), no time masking (``mask_time_prob`` 0.075, span 10): the
model computes the same in training and evaluation.

Parameters live in one flat dict keyed by the program's ``state_dict``
names (``spec``), so one dict of tensors drawn by the harness serves both
sides. Float32 runs with TF32 off (``exact``); ``step`` trains through the
plain Adam of ``train.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import EMBEDDING, exact
from .train import Adam
from .train import step as train_step

KEYS = ("conv_dim", "conv_kernel", "conv_stride", "hidden_size", "num_hidden_layers", "num_attention_heads",
        "intermediate_size", "num_conv_pos_embeddings", "num_conv_pos_embedding_groups", "layer_norm_eps")


def dims(config: Dict) -> Dict:
    """The widths the model reads from a configuration's dict."""
    return {k: config[k] for k in KEYS}


def spec(config: Dict, num_labels: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's key and shape, in the program's order."""
    d = dims(config)
    out: Dict[str, Tuple[int, ...]] = {}
    cin = 1
    for i, (c, k) in enumerate(zip(d["conv_dim"], d["conv_kernel"])):
        pre = f"trunk.feature_extractor.conv_layers.{i}"
        out[f"{pre}.conv.weight"] = (c, cin, k)
        out[f"{pre}.conv.bias"] = (c,)
        out[f"{pre}.layer_norm.weight"] = (c,)
        out[f"{pre}.layer_norm.bias"] = (c,)
        cin = c
    h, ff = d["hidden_size"], d["intermediate_size"]
    out["trunk.feature_projection.layer_norm.weight"] = (cin,)
    out["trunk.feature_projection.layer_norm.bias"] = (cin,)
    out["trunk.feature_projection.projection.weight"] = (h, cin)
    out["trunk.feature_projection.projection.bias"] = (h,)
    k, g = d["num_conv_pos_embeddings"], d["num_conv_pos_embedding_groups"]
    out["trunk.encoder.pos_conv_embed.conv.bias"] = (h,)
    out["trunk.encoder.pos_conv_embed.conv.parametrizations.weight.original0"] = (1, 1, k)
    out["trunk.encoder.pos_conv_embed.conv.parametrizations.weight.original1"] = (h, h // g, k)
    out["trunk.encoder.layer_norm.weight"] = (h,)
    out["trunk.encoder.layer_norm.bias"] = (h,)
    for i in range(d["num_hidden_layers"]):
        pre = f"trunk.encoder.layers.{i}"
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out[f"{pre}.attention.{name}.weight"] = (h, h)
            out[f"{pre}.attention.{name}.bias"] = (h,)
        out[f"{pre}.layer_norm.weight"] = (h,)
        out[f"{pre}.layer_norm.bias"] = (h,)
        out[f"{pre}.feed_forward.intermediate_dense.weight"] = (ff, h)
        out[f"{pre}.feed_forward.intermediate_dense.bias"] = (ff,)
        out[f"{pre}.feed_forward.output_dense.weight"] = (h, ff)
        out[f"{pre}.feed_forward.output_dense.bias"] = (h,)
        out[f"{pre}.final_layer_norm.weight"] = (h,)
        out[f"{pre}.final_layer_norm.bias"] = (h,)
    for key, cout, cin in (("embedding_head.dense_0", 1024, h), ("embedding_head.dense_1", 1024, 1024),
                           ("embedding_head.dense_2", EMBEDDING, 1024), ("classifier", num_labels, EMBEDDING)):
        out[f"{key}.weight"] = (cout, cin)
        out[f"{key}.bias"] = (cout,)
    return out


def normalize(wav_int16: np.ndarray) -> np.ndarray:
    """(B, samples) int16 -> float32: / 32768, then each clip's (x - mean) /
    sqrt(var + 1e-7), the biased variance, in float64."""
    x = wav_int16.astype(np.float32).astype(np.float64) / 32768.0
    mean = x.mean(axis=-1, keepdims=True)
    var = ((x - mean) ** 2).mean(axis=-1, keepdims=True)
    return ((x - mean) / np.sqrt(var + 1e-7)).astype(np.float32)


class Model:
    """The embedding model over the parameters ``p`` (keys as ``spec``)."""

    def __init__(self, p: Dict[str, torch.Tensor], config: Dict):
        self.p, self.d = p, dims(config)

    def dense(self, key, x):
        return x @ self.p[key + ".weight"].t() + self.p[key + ".bias"]

    def layer_norm(self, key, x):
        return F.layer_norm(x, x.shape[-1:], self.p[key + ".weight"], self.p[key + ".bias"], self.d["layer_norm_eps"])

    def features(self, wave):
        """(B, samples) -> (B, frames, hidden)."""
        x = wave[:, None, :]
        for i, s in enumerate(self.d["conv_stride"]):
            pre = f"trunk.feature_extractor.conv_layers.{i}"
            x = F.conv1d(x, self.p[pre + ".conv.weight"], self.p[pre + ".conv.bias"], stride=s)
            # the conv layers' LayerNorm has torch's default eps
            x = F.gelu(F.layer_norm(x.transpose(1, 2), x.shape[1:2], self.p[pre + ".layer_norm.weight"],
                                    self.p[pre + ".layer_norm.bias"], 1e-5), approximate="none").transpose(1, 2)
        x = self.layer_norm("trunk.feature_projection.layer_norm", x.transpose(1, 2))
        return self.dense("trunk.feature_projection.projection", x)

    def positional(self, x):
        pre = "trunk.encoder.pos_conv_embed.conv"
        g = self.p[pre + ".parametrizations.weight.original0"]
        v = self.p[pre + ".parametrizations.weight.original1"]
        w = v * (g / v.norm(dim=(0, 1), keepdim=True))
        k = self.d["num_conv_pos_embeddings"]
        y = F.conv1d(x.transpose(1, 2), w, self.p[pre + ".bias"], padding=k // 2,
                     groups=self.d["num_conv_pos_embedding_groups"])
        if k % 2 == 0:
            y = y[:, :, :-1]
        return F.gelu(y, approximate="none").transpose(1, 2)

    def attention(self, pre, x):
        b, t, h = x.shape
        n = self.d["num_attention_heads"]

        def heads(y):
            return y.reshape(b, t, n, h // n).permute(0, 2, 1, 3)

        q = heads(self.dense(pre + ".q_proj", x))
        k = heads(self.dense(pre + ".k_proj", x))
        v = heads(self.dense(pre + ".v_proj", x))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(h // n)
        e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
        a = e / e.sum(dim=-1, keepdim=True)
        return self.dense(pre + ".out_proj", (a @ v).permute(0, 2, 1, 3).reshape(b, t, h))

    def encoder(self, x):
        x = x + self.positional(x)
        for i in range(self.d["num_hidden_layers"]):
            pre = f"trunk.encoder.layers.{i}"
            x = x + self.attention(pre + ".attention", self.layer_norm(pre + ".layer_norm", x))
            y = self.layer_norm(pre + ".final_layer_norm", x)
            y = F.gelu(self.dense(pre + ".feed_forward.intermediate_dense", y), approximate="none")
            x = x + self.dense(pre + ".feed_forward.output_dense", y)
        return self.layer_norm("trunk.encoder.layer_norm", x)

    def trunk(self, wave):
        return self.encoder(self.features(wave))

    def embed(self, wave):
        x = self.trunk(wave).mean(dim=1)
        x = torch.relu(self.dense("embedding_head.dense_0", x))
        x = torch.relu(self.dense("embedding_head.dense_1", x))
        return F.selu(self.dense("embedding_head.dense_2", x))

    def __call__(self, wave, train: bool = False, drop_generator=None):
        """Logits; ``train`` and ``drop_generator`` change nothing (no
        dropout)."""
        return self.dense("classifier", self.embed(wave))


def step(model: Model, p: Dict[str, torch.Tensor], opt: Adam, wave: torch.Tensor, labels: torch.Tensor,
         rows: slice = slice(None), precision=exact):
    """One training step (``train.step``: mean cross-entropy, autograd,
    Adam) on normalized waveforms, float32 with TF32 off unless
    ``precision`` says otherwise: (loss, gradients)."""
    with precision():
        return train_step(model, p, opt, wave, labels, None, rows)
