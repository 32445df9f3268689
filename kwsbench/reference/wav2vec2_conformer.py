"""The wav2vec 2.0 Conformer (rel-pos) embedding model in plain PyTorch,
written from the published description, with no kernel, module, cache or
CUDA graph of the program.

- Input, feature encoder and feature projection: XLS-R's, as
  ``reference/wav2vec2.py`` computes them (its ``Model.features`` and
  ``normalize``, by import).
- Relative encodings (Transformer-XL, arXiv:1901.02860, as ``transformers``'
  ``Wav2Vec2ConformerRelPositionalEmbedding`` builds them): a table of
  ``max_source_positions`` positive and negative positions, sin at even and
  cos at odd channels in float32, the positive half reversed; the middle
  2T - 1 rows (relative positions T - 1 .. -(T - 1)) are a forward's.
- Encoder (fairseq S2T, arXiv:2010.05171; Conformer, arXiv:2005.08100):
  ``num_hidden_layers`` blocks of

  1. x + FFN1(LN(x)) x 0.5, FFN = dense, swish (x sigmoid(x), written out),
     dense;
  2. x + MHSA(LN(x)) with relative positions: per head
     ((q + u) k^T + shift((q + v) p^T)) / sqrt(head size), p the relative
     encodings through ``linear_pos`` (no bias), the shift written as
     ``transformers``' pad-and-view (a zero column in front, the rows
     re-viewed one longer, the first dropped, the first T columns kept),
     the softmax written out (exp(s - max) / sum);
  3. x + Conv(x): LN, pointwise convolution to 2C (``F.conv1d`` on (B, C,
     T), as ``transformers``), GLU written out (a x sigmoid(b)), depthwise
     convolution of ``conv_depthwise_kernel_size`` (padding k // 2),
     BatchNorm1d written out, swish, pointwise convolution back;
  4. LN(x + FFN2(LN(x)) x 0.5);

  then the encoder's LayerNorm (``layer_norm_eps``; the blocks' LayerNorms
  take 1e-5, torch's default, as ``transformers`` builds them).
- BatchNorm1d in training: the batch's mean and biased variance over (B, T)
  normalize; the running mean moves 0.1 of the way to the batch mean and
  the running variance 0.1 of the way to the unbiased variance (x n / (n -
  1)), and ``num_batches_tracked`` counts the step, in the parameter dict,
  once a forward. In evaluation it normalizes by the running statistics.
  eps 1e-5, momentum 0.1 (torch's defaults, which ``transformers`` keeps).
- Embedding head and logits: ``reference/wav2vec2.py``'s.

Departures from the published model, which the benchmark's configuration
lists as assumed: no dropout (0.1 in the published configuration, as
recalled), no layerdrop, no time masking (``mask_time_prob`` 0, so no
``masked_spec_embed``); and no ``pos_conv_embed``: ``transformers`` builds
it for this model but its Conformer encoder never applies it, so it is left
out here and in the program.

Parameters and BN statistics live in one flat dict keyed by the program's
``state_dict`` names (``spec``), so one dict of tensors drawn by the harness
serves both sides. Float32 runs with TF32 off (``exact``, set by ``step``);
``step`` trains through the plain Adam of ``train.py`` (statistics are not
parameters: ``train.parameter_keys``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import wav2vec2 as w2v
from .model import EMBEDDING, exact
from .train import Adam
from .train import step as train_step

KEYS = ("conv_dim", "conv_kernel", "conv_stride", "hidden_size", "num_hidden_layers", "num_attention_heads",
        "intermediate_size", "conv_depthwise_kernel_size", "max_source_positions", "layer_norm_eps")
BN_MOMENTUM, BN_EPS, BLOCK_LN_EPS = 0.1, 1e-5, 1e-5
normalize = w2v.normalize


def dims(config: Dict) -> Dict:
    """The widths the model reads from a configuration's dict."""
    return {k: config[k] for k in KEYS}


def spec(config: Dict, num_labels: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's and BN statistic's key and shape, in the program's
    order."""
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
    h, ff, n = d["hidden_size"], d["intermediate_size"], d["num_attention_heads"]
    out["trunk.feature_projection.layer_norm.weight"] = (cin,)
    out["trunk.feature_projection.layer_norm.bias"] = (cin,)
    out["trunk.feature_projection.projection.weight"] = (h, cin)
    out["trunk.feature_projection.projection.bias"] = (h,)
    out["trunk.encoder.layer_norm.weight"] = (h,)
    out["trunk.encoder.layer_norm.bias"] = (h,)

    def norm(key):
        out[f"{key}.weight"] = (h,)
        out[f"{key}.bias"] = (h,)

    def ffn(key):
        out[f"{key}.intermediate_dense.weight"] = (ff, h)
        out[f"{key}.intermediate_dense.bias"] = (ff,)
        out[f"{key}.output_dense.weight"] = (h, ff)
        out[f"{key}.output_dense.bias"] = (h,)

    for i in range(d["num_hidden_layers"]):
        pre = f"trunk.encoder.layers.{i}"
        norm(f"{pre}.ffn1_layer_norm")
        ffn(f"{pre}.ffn1")
        norm(f"{pre}.self_attn_layer_norm")
        out[f"{pre}.self_attn.pos_bias_u"] = (n, h // n)
        out[f"{pre}.self_attn.pos_bias_v"] = (n, h // n)
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            out[f"{pre}.self_attn.{name}.weight"] = (h, h)
            out[f"{pre}.self_attn.{name}.bias"] = (h,)
        out[f"{pre}.self_attn.linear_pos.weight"] = (h, h)
        conv = f"{pre}.conv_module"
        norm(f"{conv}.layer_norm")
        out[f"{conv}.pointwise_conv1.weight"] = (2 * h, h, 1)
        out[f"{conv}.depthwise_conv.weight"] = (h, 1, d["conv_depthwise_kernel_size"])
        norm(f"{conv}.batch_norm")
        out[f"{conv}.batch_norm.running_mean"] = (h,)
        out[f"{conv}.batch_norm.running_var"] = (h,)
        out[f"{conv}.batch_norm.num_batches_tracked"] = ()
        out[f"{conv}.pointwise_conv2.weight"] = (h, h, 1)
        norm(f"{pre}.ffn2_layer_norm")
        ffn(f"{pre}.ffn2")
        norm(f"{pre}.final_layer_norm")
    for key, cout, cin in (("embedding_head.dense_0", 1024, h), ("embedding_head.dense_1", 1024, 1024),
                           ("embedding_head.dense_2", EMBEDDING, 1024), ("classifier", num_labels, EMBEDDING)):
        out[f"{key}.weight"] = (cout, cin)
        out[f"{key}.bias"] = (cout,)
    return out


def batch_norm_keys(config: Dict):
    """The (running mean, running variance) keys of each block's BatchNorm."""
    pre = "trunk.encoder.layers.{}.conv_module.batch_norm."
    return [(pre.format(i) + "running_mean", pre.format(i) + "running_var")
            for i in range(dims(config)["num_hidden_layers"])]


def relative_table(max_len: int, hidden: int) -> torch.Tensor:
    """(2 max_len - 1, hidden) float32: relative positions max_len - 1 ..
    -(max_len - 1)."""
    pos = torch.arange(0, max_len, dtype=torch.int64).float().unsqueeze(1)
    div = torch.exp(torch.arange(0, hidden, 2, dtype=torch.int64).float() * -(math.log(10000.0) / hidden))
    positive, negative = torch.zeros(max_len, hidden), torch.zeros(max_len, hidden)
    positive[:, 0::2], positive[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
    negative[:, 0::2], negative[:, 1::2] = torch.sin(-1 * pos * div), torch.cos(-1 * pos * div)
    return torch.cat([torch.flip(positive, [0]), negative[1:]])


def shift(bd: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T - 1) -> (B, H, T, T): ``transformers``' pad-and-view."""
    zero = torch.zeros((*bd.shape[:3], 1), device=bd.device, dtype=bd.dtype)
    padded = torch.cat([zero, bd], dim=-1).view(*bd.shape[:2], bd.shape[3] + 1, bd.shape[2])
    return padded[:, :, 1:].reshape(bd.shape)[:, :, :, : bd.shape[-1] // 2 + 1]


def swish(x):
    return x * torch.sigmoid(x)


class Model(w2v.Model):
    """The embedding model over the parameters and statistics ``p`` (keys
    as ``spec``); ``__call__(wave, train)``: logits, BatchNorm on the batch
    and its running statistics moved in ``p`` when ``train``."""

    def __init__(self, p: Dict[str, torch.Tensor], config: Dict):
        self.p, self.d = p, dims(config)
        self.train = False
        self._table = None

    def positions(self, t: int, device) -> torch.Tensor:
        if self._table is None:
            self._table = relative_table(self.d["max_source_positions"], self.d["hidden_size"])
        mid = self._table.shape[0] // 2
        return self._table[mid - t + 1: mid + t].to(device)[None]

    def block_norm(self, key, x):
        return F.layer_norm(x, x.shape[-1:], self.p[key + ".weight"], self.p[key + ".bias"], BLOCK_LN_EPS)

    def ffn(self, key, x):
        return self.dense(key + ".output_dense", swish(self.dense(key + ".intermediate_dense", x)))

    def attention(self, pre, x, pos):
        b, t, h = x.shape
        n = self.d["num_attention_heads"]
        dk = h // n
        q = self.dense(pre + ".linear_q", x).view(b, t, n, dk)
        k = self.dense(pre + ".linear_k", x).view(b, t, n, dk).transpose(1, 2)
        v = self.dense(pre + ".linear_v", x).view(b, t, n, dk).transpose(1, 2)
        p = (pos @ self.p[pre + ".linear_pos.weight"].t()).view(1, -1, n, dk).transpose(1, 2).transpose(2, 3)
        ac = (q + self.p[pre + ".pos_bias_u"]).transpose(1, 2) @ k.transpose(-2, -1)
        bd = shift((q + self.p[pre + ".pos_bias_v"]).transpose(1, 2) @ p)
        s = (ac + bd) / math.sqrt(dk)
        e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
        a = e / e.sum(dim=-1, keepdim=True)
        return self.dense(pre + ".linear_out", (a @ v).transpose(1, 2).reshape(b, t, h))

    def batch_norm(self, key, x):
        """(B, C, T), in train mode moving the running statistics in ``p``."""
        w, b = self.p[key + ".weight"][None, :, None], self.p[key + ".bias"][None, :, None]
        if not self.train:
            mean, var = self.p[key + ".running_mean"], self.p[key + ".running_var"]
            return (x - mean[None, :, None]) / torch.sqrt(var[None, :, None] + BN_EPS) * w + b
        mean = x.mean(dim=(0, 2))
        var = (x - mean[None, :, None]).square().mean(dim=(0, 2))
        count = x.shape[0] * x.shape[2]
        with torch.no_grad():
            rm, rv = self.p[key + ".running_mean"], self.p[key + ".running_var"]
            rm.copy_((1.0 - BN_MOMENTUM) * rm + BN_MOMENTUM * mean)
            rv.copy_((1.0 - BN_MOMENTUM) * rv + BN_MOMENTUM * var * (count / (count - 1)))
            self.p[key + ".num_batches_tracked"].add_(1)
        return (x - mean[None, :, None]) / torch.sqrt(var[None, :, None] + BN_EPS) * w + b

    def conv_module(self, pre, x):
        y = self.block_norm(pre + ".layer_norm", x).transpose(1, 2)
        y = F.conv1d(y, self.p[pre + ".pointwise_conv1.weight"])
        a, g = y.chunk(2, dim=1)
        y = a * torch.sigmoid(g)
        k = self.d["conv_depthwise_kernel_size"]
        y = F.conv1d(y, self.p[pre + ".depthwise_conv.weight"], padding=(k - 1) // 2, groups=y.shape[1])
        y = swish(self.batch_norm(pre + ".batch_norm", y))
        return F.conv1d(y, self.p[pre + ".pointwise_conv2.weight"]).transpose(1, 2)

    def encoder(self, x):
        pos = self.positions(x.shape[1], x.device)
        for i in range(self.d["num_hidden_layers"]):
            pre = f"trunk.encoder.layers.{i}"
            x = self.ffn(pre + ".ffn1", self.block_norm(pre + ".ffn1_layer_norm", x)) * 0.5 + x
            x = self.attention(pre + ".self_attn", self.block_norm(pre + ".self_attn_layer_norm", x), pos) + x
            x = x + self.conv_module(pre + ".conv_module", x)
            x = self.ffn(pre + ".ffn2", self.block_norm(pre + ".ffn2_layer_norm", x)) * 0.5 + x
            x = self.block_norm(pre + ".final_layer_norm", x)
        return self.layer_norm("trunk.encoder.layer_norm", x)

    def __call__(self, wave, train: bool = False, drop_generator=None):
        """Logits; ``train`` puts BatchNorm on the batch's statistics and
        moves the running ones; ``drop_generator`` changes nothing (no
        dropout)."""
        self.train = train
        return self.dense("classifier", self.embed(wave))


def step(model: Model, p: Dict[str, torch.Tensor], opt: Adam, wave: torch.Tensor, labels: torch.Tensor,
         rows: slice = slice(None), precision=exact):
    """One training step (``train.step``: mean cross-entropy, autograd,
    Adam; BatchNorm's running statistics moved) on normalized waveforms,
    float32 with TF32 off unless ``precision`` says otherwise: (loss,
    gradients)."""
    with precision():
        return train_step(model, p, opt, wave, labels, None, rows)
