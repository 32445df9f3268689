"""wav2vec 2.0 trunk in plain torch ops: the XLS-R layout (arXiv:2111.09296,
arXiv:2006.11477) as Hugging Face's ``Wav2Vec2Model`` computes it with
``feat_extract_norm="layer"`` and ``do_stable_layer_norm=True``.

- Feature encoder: 7 Conv1d layers over the waveform (``conv_dim``,
  ``conv_kernel``, ``conv_stride``, with bias), each followed by LayerNorm
  over its channels and erf GELU. One second at 16 kHz becomes 3,199 ->
  1,599 -> 799 -> 399 -> 199 -> 99 -> 49 frames.
- Feature projection: LayerNorm over the last conv's channels, Linear to
  ``hidden_size``.
- Positional convolution: a grouped Conv1d (kernel
  ``num_conv_pos_embeddings``, ``num_conv_pos_embedding_groups`` groups,
  padding kernel // 2, the last frame dropped for an even kernel) under
  weight norm over dim 2 (parameters ``g`` and ``v``, torch's
  ``parametrizations.weight_norm``, so training updates both), then GELU;
  its output is added to the projected features.
- Transformer: ``num_hidden_layers`` pre-LN layers, ``x += Attn(LN(x))``
  (softmax(QK^T / sqrt(head size))V over ``num_attention_heads`` heads) and
  ``x += FF(LN(x))`` (Linear to ``intermediate_size``, GELU, Linear back),
  then a final LayerNorm.

Dropout, layerdrop and the time masking of ``apply_spec_augment`` are
absent: the trunk computes the same in training and evaluation. Parameter
names are ``Wav2Vec2Model``'s, so its ``state_dict`` (built with
``mask_time_prob=0``, which has no ``masked_spec_embed``) loads strictly.

The trunk takes (B, samples) float32 waveforms, each normalized to zero
mean and unit variance (``Wav2Vec2FeatureExtractor``'s ``do_normalize``;
``data/dataset.normalized_waveform``), and returns (B, frames,
hidden_size); ``takes_waveform`` tells the data path so. Float32 only (the
callers run it under ``exact_float32``, no TF32).

Under a profiler the forward records two spans (``utils/profiling.annotate``):
``w2v.features`` (the feature encoder and the projection; counts
``samples``, ``frames`` and ``tokens``, batch x frames) and ``w2v.encoder``
(the positional convolution and the layers; counts ``frames`` and
``tokens``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate


@dataclass(frozen=True)
class Wav2Vec2Config:
    """The trunk's widths; the defaults are XLS-R 300M's
    (huggingface.co/facebook/wav2vec2-xls-r-300m, config.json)."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: Dict) -> "Wav2Vec2Config":
        """The fields ``d`` names (a configuration file, or
        ``transformers``' ``Wav2Vec2Config.to_dict()``); others are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})


XLSR_300M = Wav2Vec2Config()


class FeatureEncoderLayer(nn.Module):
    """Conv1d -> LayerNorm over channels -> GELU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, bias: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, bias=bias)
        self.layer_norm = nn.LayerNorm(cout)

    def forward(self, x):
        x = self.conv(x)
        x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        cins = (1,) + tuple(c.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            FeatureEncoderLayer(i, o, k, s, c.conv_bias)
            for i, o, k, s in zip(cins, c.conv_dim, c.conv_kernel, c.conv_stride)
        )

    def forward(self, wave):
        x = wave[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x  # (B, C, T)


class FeatureProjection(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c.conv_dim[-1], eps=c.layer_norm_eps)
        self.projection = nn.Linear(c.conv_dim[-1], c.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    """Grouped Conv1d under weight norm (dim 2), the trailing frame of an
    even kernel dropped, GELU: (B, T, H) -> (B, T, H)."""

    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        k = c.num_conv_pos_embeddings
        conv = nn.Conv1d(c.hidden_size, c.hidden_size, k, padding=k // 2, groups=c.num_conv_pos_embedding_groups)
        self.conv = nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
        self.drop_last = k % 2 == 0

    def forward(self, x):
        y = self.conv(x.transpose(1, 2))
        if self.drop_last:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        h = c.hidden_size
        self.heads = c.num_attention_heads
        self.head_dim = h // self.heads
        self.scale = self.head_dim ** -0.5
        # transformers' order, so the state dicts list the same keys in turn
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.q_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x):
        b, t, h = x.shape

        def heads(y):
            return y.view(b, t, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * self.scale, dim=-1)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, h)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output_dense = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Pre-LN: x + Attn(LN(x)), then + FF(LN(x))."""

    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.attention = Attention(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x):
        x = x + self.attention(self.layer_norm(x))
        return x + self.feed_forward(self.final_layer_norm(x))


class Encoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(c) for _ in range(c.num_hidden_layers))

    def forward(self, x):
        x = x + self.pos_conv_embed(x)
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class Wav2Vec2Trunk(nn.Module):
    """(B, samples) normalized float32 waveforms -> (B, frames, hidden_size).

    ``takes_waveform``, ``out_channels`` and ``pool_dims`` (the time axis)
    are what the embedding model and the data path read off a trunk."""

    takes_waveform = True
    pool_dims = (1,)

    def __init__(self, config: Wav2Vec2Config = XLSR_300M, compute_dtype=None):
        super().__init__()
        if compute_dtype not in (None, "float32", torch.float32):
            raise ValueError(f"the wav2vec 2.0 trunk computes in float32 only, not {compute_dtype}")
        self.config = config
        self.out_channels = config.hidden_size
        self.feature_extractor = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config)

    def forward(self, wave, drop_generator=None):
        """``drop_generator`` is accepted for the trunks' common call and
        not drawn from: the trunk has no dropout."""
        with annotate("w2v.features") as span:
            hidden = self.feature_projection(self.feature_extractor(wave).transpose(1, 2))
            b, t = hidden.shape[:2]
            span.count(samples=wave.shape[-1], frames=t, tokens=b * t)
        with annotate("w2v.encoder") as span:
            out = self.encoder(hidden)
            span.count(frames=t, tokens=b * t)
        return out


@torch.no_grad()
def wav2vec2_init_(trunk: Wav2Vec2Trunk, seed: int) -> Wav2Vec2Trunk:
    """``transformers``' ``Wav2Vec2PreTrainedModel._init_weights``, from one
    seeded generator on the trunk's device: Linear N(0, 0.02) with zero
    bias; LayerNorm identity; the feature projection U(+-1/sqrt(fan_in)),
    bias too; convs Kaiming-normal, bias U(+-sqrt(groups / (cin *
    kernel))); the positional conv's weight N(0, 2 / sqrt(kernel *
    channels)), its ``v`` that weight and its ``g`` that weight's norm (so
    the weight is the draw), bias zero. A Conformer trunk
    (``models/wav2vec2_conformer.py``, ``Wav2Vec2ConformerPreTrainedModel``'s
    rule) has no positional conv; its attention's ``pos_bias_u`` and
    ``pos_bias_v`` are Xavier-uniform, its BatchNorm torch's default (scale
    1, shift 0, statistics 0 and 1)."""
    dev = next(trunk.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    proj = trunk.feature_projection.projection
    pos = getattr(trunk.encoder, "pos_conv_embed", None)
    pos = pos.conv if pos is not None else None
    for mod in trunk.modules():
        for name in ("pos_bias_u", "pos_bias_v"):
            if isinstance(getattr(mod, name, None), nn.Parameter):
                bias = getattr(mod, name)
                k = math.sqrt(6.0 / sum(bias.shape))  # xavier_uniform_ of (heads, head size)
                bias.uniform_(-k, k, generator=gen)
        if mod is proj:
            k = 1.0 / math.sqrt(mod.in_features)
            mod.weight.uniform_(-k, k, generator=gen)
            mod.bias.uniform_(-k, k, generator=gen)
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 0.02, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif mod is pos:
            p = mod.parametrizations.weight
            std = 2.0 * math.sqrt(1.0 / (mod.kernel_size[0] * mod.in_channels))
            p.original1.normal_(0.0, std, generator=gen)
            p.original0.copy_(p.original1.norm(dim=(0, 1), keepdim=True))
            mod.bias.zero_()
        elif isinstance(mod, nn.Conv1d):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
            if mod.bias is not None:
                k = math.sqrt(mod.groups / (mod.in_channels * mod.kernel_size[0]))
                mod.bias.uniform_(-k, k, generator=gen)
        elif isinstance(mod, nn.BatchNorm1d):
            mod.reset_parameters()
    return trunk
