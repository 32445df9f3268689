"""wav2vec 2.0 Conformer trunk in plain torch ops: the rel-pos layout
(``facebook/wav2vec2-conformer-rel-pos-large``; fairseq S2T,
arXiv:2010.05171; Conformer, arXiv:2005.08100) as Hugging Face's
``Wav2Vec2ConformerModel`` computes it with ``position_embeddings_type=
"relative"``, ``feat_extract_norm="layer"`` and ``hidden_act="swish"``.

- Feature encoder and projection: XLS-R's (``models/wav2vec2.py``'s
  ``FeatureEncoder`` and ``FeatureProjection``, shared by import).
- Relative encodings: sinusoids of the relative positions T - 1 .. -(T - 1)
  (Transformer-XL, arXiv:1901.02860), (1, 2T - 1, hidden_size), computed
  once per length in float32 on the host as ``transformers`` computes them
  and kept on the device (``ConformerEncoder.positions``); they never
  depend on the batch.
- Encoder: ``num_hidden_layers`` Conformer blocks, then a LayerNorm. A
  block computes, in order:

  1. ``x += FFN1(LN(x)) / 2``, the macaron half step (Linear to
     ``intermediate_size``, swish, Linear back);
  2. ``x += RelMHSA(LN(x))``: per head, scores ``((q + u) k^T +
     shift((q + v) p^T)) / sqrt(head size)``, where p is ``linear_pos`` of
     the relative encodings (no bias; it runs once a batch: its input has
     batch 1), u and v are the learned ``pos_bias_u`` and ``pos_bias_v``,
     and ``shift`` (``rel_shift``) puts relative position i - j at (i, j);
     softmax over the keys, times the values, ``linear_out``;
  3. ``x += Conv(x)``: LayerNorm, pointwise 1 x 1 to 2 x hidden, GLU,
     depthwise Conv1d of ``conv_depthwise_kernel_size`` (padding k // 2),
     BatchNorm1d, swish, pointwise 1 x 1 back;
  4. ``x = LN(x + FFN2(LN(x)) / 2)``.

  The blocks' LayerNorms take torch's default eps (1e-5), as
  ``transformers`` builds them; the encoder's and the projection's take
  ``layer_norm_eps``.

The pointwise convolutions hold ``Conv1d`` weights (B, C, 1), as
``transformers`` names them, and run as row products on the (B, T, C)
activations, so only the depthwise convolution and its BatchNorm see the
(B, C, T) layout. BatchNorm1d is torch's (momentum 0.1, eps 1e-5): in train
mode it normalizes by the batch's statistics over (B, T) and moves its
running ones once a forward, inside the training step (and the CUDA graph
that replays it); in eval mode it reads them. Nothing calibrates them
(``train/pretrain.py`` calibrates B0's BatchNorm2d only).

``transformers`` builds a positional convolution (``pos_conv_embed``) that
its Conformer encoder never applies, and ``masked_spec_embed`` for the time
masking: both are absent here, so the parameter names are
``Wav2Vec2ConformerModel``'s without them. Dropout, layerdrop and time
masking are absent, as in the XLS-R trunk. Float32 only (the callers run
it under ``exact_float32``, no TF32). BatchNorm1d normalizes one process's
rows, so a training forward under a process group of more than one rank is
refused: data-parallel pretraining would not be the step of one process on
the global batch (``train/pretrain.py``).

Under a profiler the forward records two spans (``utils/profiling.annotate``):
``w2v.features`` (as the XLS-R trunk: counts ``samples``, ``frames`` and
``tokens``) and ``conformer.encoder`` (the blocks; counts ``frames``,
``tokens``, batch x frames, and ``rel_positions``, 2T - 1).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from ..utils.profiling import annotate
from .wav2vec2 import FeatureEncoder, FeatureProjection


@dataclass(frozen=True)
class Wav2Vec2ConformerConfig:
    """The trunk's widths; the defaults are rel-pos-large's
    (huggingface.co/facebook/wav2vec2-conformer-rel-pos-large, config.json)."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_depthwise_kernel_size: int = 31
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: Dict) -> "Wav2Vec2ConformerConfig":
        """The fields ``d`` names (a configuration file, or ``transformers``'
        ``Wav2Vec2ConformerConfig.to_dict()``); others are ignored, but a
        position type other than "relative" or an activation other than
        swish is refused: the trunk computes those only."""
        if d.get("position_embeddings_type", "relative") != "relative":
            raise ValueError(f"the Conformer trunk has relative positions only, not {d['position_embeddings_type']!r}")
        if d.get("hidden_act", "swish") not in ("swish", "silu"):
            raise ValueError(f"the Conformer trunk's activation is swish, not {d['hidden_act']!r}")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})


CONFORMER_REL_POS_LARGE = Wav2Vec2ConformerConfig()


def relative_encodings(frames: int, hidden: int) -> torch.Tensor:
    """(1, 2 x frames - 1, hidden) float32 on the host: row r encodes the
    relative position frames - 1 - r, sin at even and cos at odd channels,
    with ``transformers``' float32 arithmetic (the values of its table of
    ``max_source_positions`` rows, sliced)."""
    position = torch.arange(0, frames, dtype=torch.int64).float().unsqueeze(1)
    div_term = torch.exp(torch.arange(0, hidden, 2, dtype=torch.int64).float() * -(math.log(10000.0) / hidden))
    positive = torch.zeros(frames, hidden)
    negative = torch.zeros(frames, hidden)
    positive[:, 0::2] = torch.sin(position * div_term)
    positive[:, 1::2] = torch.cos(position * div_term)
    negative[:, 0::2] = torch.sin(-1 * position * div_term)
    negative[:, 1::2] = torch.cos(-1 * position * div_term)
    return torch.cat([torch.flip(positive, [0]), negative[1:]])[None]


def rel_shift(scores: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T - 1) scores against the relative positions T - 1 ..
    -(T - 1) -> (B, H, T, T) with ``out[..., i, j] = scores[..., i, T - 1 - i
    + j]``, the score of relative position i - j: Transformer-XL's
    pad-and-view shift as one strided view, no copy."""
    scores = scores.contiguous()
    b, h, t, w = scores.shape
    return scores.as_strided((b, h, t, t), (h * t * w, t * w, w - 1, 1), scores.storage_offset() + t - 1)


class FeedForward(nn.Module):
    def __init__(self, c: Wav2Vec2ConformerConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output_dense = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class RelPositionAttention(nn.Module):
    """Multi-head self-attention with Transformer-XL relative positions."""

    def __init__(self, c: Wav2Vec2ConformerConfig):
        super().__init__()
        h = c.hidden_size
        self.heads = c.num_attention_heads
        self.head_dim = h // self.heads
        # transformers' order, so the state dicts list the same keys in turn
        self.linear_q = nn.Linear(h, h)
        self.linear_k = nn.Linear(h, h)
        self.linear_v = nn.Linear(h, h)
        self.linear_out = nn.Linear(h, h)
        self.linear_pos = nn.Linear(h, h, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(self.heads, self.head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(self.heads, self.head_dim))

    def forward(self, x, positions):
        """x (B, T, H); positions (1, 2T - 1, H), ``relative_encodings``."""
        b, t, h = x.shape
        n, d = self.heads, self.head_dim
        q = self.linear_q(x).view(b, t, n, d)
        k = self.linear_k(x).view(b, t, n, d).transpose(1, 2)
        v = self.linear_v(x).view(b, t, n, d).transpose(1, 2)
        p = self.linear_pos(positions).view(1, 2 * t - 1, n, d).permute(0, 2, 3, 1)  # (1, n, d, 2T - 1)
        content = torch.matmul((q + self.pos_bias_u).transpose(1, 2), k.transpose(-1, -2))
        position = rel_shift(torch.matmul((q + self.pos_bias_v).transpose(1, 2), p))
        weights = torch.softmax((content + position) / math.sqrt(d), dim=-1)
        return self.linear_out(torch.matmul(weights, v).transpose(1, 2).reshape(b, t, h))


class ConvolutionModule(nn.Module):
    """LN -> pointwise to 2C -> GLU -> depthwise Conv1d -> BatchNorm1d ->
    swish -> pointwise back, on (B, T, C)."""

    def __init__(self, c: Wav2Vec2ConformerConfig):
        super().__init__()
        h, k = c.hidden_size, c.conv_depthwise_kernel_size
        if k % 2 != 1:
            raise ValueError(f"the depthwise kernel must be odd for 'same' padding, not {k}")
        self.layer_norm = nn.LayerNorm(h)
        self.pointwise_conv1 = nn.Conv1d(h, 2 * h, 1, bias=False)
        self.depthwise_conv = nn.Conv1d(h, h, k, padding=k // 2, groups=h, bias=False)
        self.batch_norm = nn.BatchNorm1d(h)
        self.pointwise_conv2 = nn.Conv1d(h, h, 1, bias=False)

    def forward(self, x):
        y = F.glu(F.linear(self.layer_norm(x), self.pointwise_conv1.weight[:, :, 0]), dim=-1)
        y = F.silu(self.batch_norm(self.depthwise_conv(y.transpose(1, 2))))
        return F.linear(y.transpose(1, 2), self.pointwise_conv2.weight[:, :, 0])


class ConformerBlock(nn.Module):
    def __init__(self, c: Wav2Vec2ConformerConfig):
        super().__init__()
        h = c.hidden_size
        self.ffn1_layer_norm = nn.LayerNorm(h)
        self.ffn1 = FeedForward(c)
        self.self_attn_layer_norm = nn.LayerNorm(h)
        self.self_attn = RelPositionAttention(c)
        self.conv_module = ConvolutionModule(c)
        self.ffn2_layer_norm = nn.LayerNorm(h)
        self.ffn2 = FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(h)

    def forward(self, x, positions):
        x = self.ffn1(self.ffn1_layer_norm(x)) * 0.5 + x
        x = self.self_attn(self.self_attn_layer_norm(x), positions) + x
        x = x + self.conv_module(x)
        return self.final_layer_norm(self.ffn2(self.ffn2_layer_norm(x)) * 0.5 + x)


class ConformerEncoder(nn.Module):
    def __init__(self, c: Wav2Vec2ConformerConfig):
        super().__init__()
        self.hidden_size = c.hidden_size
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(ConformerBlock(c) for _ in range(c.num_hidden_layers))
        self._positions: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def positions(self, frames: int, device) -> torch.Tensor:
        """``relative_encodings`` for ``frames`` on ``device``, made on the
        first call for that length (an eager call: a CUDA graph captures
        later ones, which only read it)."""
        key = (frames, torch.device(device))
        if key not in self._positions:
            self._positions[key] = relative_encodings(frames, self.hidden_size).to(device)
        return self._positions[key]

    def forward(self, x):
        positions = self.positions(x.shape[1], x.device)
        for layer in self.layers:
            x = layer(x, positions)
        return self.layer_norm(x)


class Wav2Vec2ConformerTrunk(nn.Module):
    """(B, samples) normalized float32 waveforms -> (B, frames, hidden_size).

    ``takes_waveform``, ``out_channels`` and ``pool_dims`` (the time axis)
    are what the embedding model and the data path read off a trunk."""

    takes_waveform = True
    pool_dims = (1,)

    def __init__(self, config: Wav2Vec2ConformerConfig = CONFORMER_REL_POS_LARGE, compute_dtype=None):
        super().__init__()
        if compute_dtype not in (None, "float32", torch.float32):
            raise ValueError(f"the wav2vec 2.0 Conformer trunk computes in float32 only, not {compute_dtype}")
        self.config = config
        self.out_channels = config.hidden_size
        self.feature_extractor = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = ConformerEncoder(config)

    def forward(self, wave, drop_generator=None):
        """``drop_generator`` is accepted for the trunks' common call and
        not drawn from: the trunk has no dropout."""
        if self.training and mesh.world_size() > 1:
            raise ValueError("the Conformer trunk's BatchNorm1d normalizes one process's rows: a training "
                             f"forward over {mesh.world_size()} ranks would not be the global batch's step")
        with annotate("w2v.features") as span:
            hidden = self.feature_projection(self.feature_extractor(wave).transpose(1, 2))
            b, t = hidden.shape[:2]
            span.count(samples=wave.shape[-1], frames=t, tokens=b * t)
        with annotate("conformer.encoder") as span:
            out = self.encoder(hidden)
            span.count(frames=t, tokens=b * t, rel_positions=2 * t - 1)
        return out
