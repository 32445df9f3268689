"""EfficientNet (B0 by default) in PyTorch, eval mode.

Counterpart of ``multilingual_kws_tpu/models/efficientnet.py``, laid out so
that Flax parameters (and through them Keras weights) carry over tensor by
tensor (``models/convert.py``). Keras-compat details kept from there:

- stride-2 convolutions pad with the asymmetric ``correct_pad`` of Keras'
  imagenet_utils, then run VALID;
- BatchNorm eps 1e-3;
- SE bottleneck width ``max(1, int(block_input_filters * se_ratio))``;
- swish activations; expansion ratio 6 except in the first stage;
- ``input_scale`` / ``input_bias`` (Keras' Rescaling(1/255) and its folded
  Normalization).

The public boundary is NHWC ``(B, H, W, 1)`` like the JAX package; inside,
tensors are NCHW.

In ``train()`` mode BatchNorm normalizes with the batch's statistics, and the
residual blocks apply drop-connect: per sample, the block's branch is kept
with probability 1 - rate and scaled by 1/(1 - rate), as Flax's
``Dropout(broadcast_dims=(1, 2, 3))`` does, with rate
``drop_connect_rate * block_index / total_blocks``. Its draws come from the
``torch.Generator`` passed as ``drop_generator``, never from the global RNG.
In ``eval()`` mode (inference and the few-shot fine-tune) neither applies.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    num_repeat: int
    filters_in: int
    filters_out: int
    expand_ratio: int
    strides: int
    se_ratio: float = 0.25


# EfficientNet-B0 baseline blocks (Tan & Le 2019, Table 1)
DEFAULT_BLOCKS: Tuple[BlockArgs, ...] = (
    BlockArgs(3, 1, 32, 16, 1, 1),
    BlockArgs(3, 2, 16, 24, 6, 2),
    BlockArgs(5, 2, 24, 40, 6, 2),
    BlockArgs(3, 3, 40, 80, 6, 2),
    BlockArgs(5, 3, 80, 112, 6, 1),
    BlockArgs(5, 4, 112, 192, 6, 2),
    BlockArgs(3, 1, 192, 320, 6, 1),
)


def round_filters(filters: int, width_coefficient: float, divisor: int = 8) -> int:
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


def correct_pad(size_hw: Tuple[int, int], kernel: int) -> Tuple[int, int, int, int]:
    """Keras correct_pad as ``F.pad`` widths (left, right, top, bottom)."""
    adjust_h, adjust_w = 1 - size_hw[0] % 2, 1 - size_hw[1] % 2
    c = kernel // 2
    return (c - adjust_w, c, c - adjust_h, c)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-3, momentum=0.01)  # Keras momentum 0.99


class Conv(nn.Conv2d):
    """Conv2d with Flax padding: SAME at stride 1 (odd kernels), Keras
    correct_pad then VALID at stride 2."""

    def __init__(self, cin, cout, kernel, strides=1, groups=1, bias=False):
        super().__init__(
            cin, cout, kernel, stride=strides, groups=groups, bias=bias,
            padding=kernel // 2 if strides == 1 else 0,
        )

    def forward(self, x):
        if self.stride[0] == 2:
            x = F.pad(x, correct_pad(x.shape[-2:], self.kernel_size[0]))
        return super().forward(x)


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, kernel, strides=1, use_act=True):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, strides)
        self.bn = _bn(cout)
        self.use_act = use_act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.use_act else x


def drop_connect(x, rate: float, generator) -> torch.Tensor:
    """Zero each sample's x with probability ``rate``, scale the rest by
    1/(1 - rate); the draws come from ``generator``."""
    if generator is None:
        raise ValueError("drop-connect in train mode needs drop_generator (a torch.Generator)")
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation."""

    def __init__(
        self, args: BlockArgs, filters_in: int, filters_out: int, strides: int, drop_rate: float = 0.0
    ):
        super().__init__()
        self.args = args
        self.drop_rate = drop_rate
        self.residual = strides == 1 and filters_in == filters_out
        expanded = filters_in * args.expand_ratio
        if args.expand_ratio != 1:
            self.expand_conv = Conv(filters_in, expanded, 1)
            self.expand_bn = _bn(expanded)
        self.dw_conv = Conv(expanded, expanded, args.kernel_size, strides, groups=expanded)
        self.dw_bn = _bn(expanded)
        self.has_se = bool(args.se_ratio and args.se_ratio > 0)
        if self.has_se:
            se_filters = max(1, int(filters_in * args.se_ratio))
            self.se_reduce = Conv(expanded, se_filters, 1, bias=True)
            self.se_expand = Conv(se_filters, expanded, 1, bias=True)
        self.project_conv = Conv(expanded, filters_out, 1)
        self.project_bn = _bn(filters_out)

    def forward(self, x, drop_generator=None):
        inputs = x
        if self.args.expand_ratio != 1:
            x = F.silu(self.expand_bn(self.expand_conv(x)))
        x = F.silu(self.dw_bn(self.dw_conv(x)))
        if self.has_se:
            se = x.mean(dim=(-2, -1), keepdim=True)
            se = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(se))))
            x = x * se
        x = self.project_bn(self.project_conv(x))
        if not self.residual:
            return x
        if self.training and self.drop_rate > 0:
            x = drop_connect(x, self.drop_rate, drop_generator)
        return x + inputs


class EfficientNet(nn.Module):
    """EfficientNet trunk (no pooling/top). Input NHWC (B, H, W, 1); returns
    the NCHW feature map of the ``top`` layer."""

    def __init__(
        self,
        width_coefficient: float = 1.0,
        depth_coefficient: float = 1.0,
        drop_connect_rate: float = 0.2,
        blocks: Tuple[BlockArgs, ...] = DEFAULT_BLOCKS,
        input_scale: float = 1.0 / 255.0,
        input_bias: float = 0.0,
    ):
        super().__init__()
        self.width_coefficient = width_coefficient
        self.depth_coefficient = depth_coefficient
        self.input_scale = input_scale
        self.input_bias = input_bias
        stem = round_filters(32, width_coefficient)
        self.stem = ConvBnAct(1, stem, 3, strides=2)  # one feature plane
        self.block_names = []
        cin = stem
        total = sum(round_repeats(b.num_repeat, depth_coefficient) for b in blocks)
        for stage, b in enumerate(blocks):
            f_in = round_filters(b.filters_in, width_coefficient)
            f_out = round_filters(b.filters_out, width_coefficient)
            for r in range(round_repeats(b.num_repeat, depth_coefficient)):
                name = f"block{stage + 1}{chr(ord('a') + r)}"
                block = MBConvBlock(
                    b, f_in if r == 0 else f_out, f_out, b.strides if r == 0 else 1,
                    drop_rate=drop_connect_rate * len(self.block_names) / total,
                )
                self.add_module(name, block)
                self.block_names.append(name)
                cin = f_out
        self.out_channels = round_filters(1280, width_coefficient)
        self.top = ConvBnAct(cin, self.out_channels, 1)

    def forward(self, x, drop_generator=None):
        x = x * self.input_scale + self.input_bias
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = self.stem(x)
        for name in self.block_names:
            x = getattr(self, name)(x, drop_generator)
        return self.top(x)


def EfficientNetB0(**kw) -> EfficientNet:
    return EfficientNet(width_coefficient=1.0, depth_coefficient=1.0, **kw)
