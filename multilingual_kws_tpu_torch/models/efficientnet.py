"""EfficientNet (B0 by default) in PyTorch.

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
tensors are indexed (N, C, H, W) and the activations are stored
channels_last: the input's NHWC strides, permuted, are channels_last's, and
every convolution keeps its input's layout.

The inference path (``EfficientNet.inference_path``: eval mode, the input
on the card, autograd recording nothing in the trunk) runs each
convolution's BatchNorm, the swish after it and the residual add as one
pass of the epilogue kernel (``ops/cuda_epilogue.bn_act``) through the
``BatchNorm`` modules, so their forward hooks still fire, and in float32
each dense convolution as a matrix product over the channels_last rows
(``rows_conv``), so no layout transpose runs. In float32 the middle of
each MBConv block, from the expand product's raw output to the gated input
of the project product (expand BatchNorm and swish, the depthwise
convolution, its BatchNorm and swish, the squeeze-excitation and its
gate), is one kernel (``ops/cuda_mbconv.mbconv_middle``): there the
``expand_bn``, ``dw_bn``, ``dw_conv``, ``se_reduce`` and ``se_expand``
modules are not called and their forward hooks do not fire; the stem's,
the project products' and the top's BatchNorms still go through their
modules (18 ``bn_act`` calls a B0 forward, 16 ``mbconv_middle``). Every
other call (train mode, a trainable trunk parameter, CPU tensors) runs the
module path: cuDNN's convolutions, BatchNorm, ``F.silu`` and the add as
separate ops.

In ``train()`` mode BatchNorm normalizes with the batch's statistics and
updates its running statistics as Flax's ``nn.BatchNorm`` does
(``BatchNorm``), and the residual blocks apply drop-connect: per sample, the
block's branch is kept with probability 1 - rate and scaled by 1/(1 - rate),
as Flax's ``Dropout(broadcast_dims=(1, 2, 3))`` does, with rate
``drop_connect_rate * block_index / total_blocks``. Its draws come from the
``torch.Generator`` passed as ``drop_generator``, never from the global RNG.
In ``eval()`` mode (inference and the few-shot fine-tune) neither applies.

Data parallelism (``parallel/mesh.py``): when a process group of more than
one rank is up, each process holds its rows of one global batch. Train-mode
BatchNorm then normalizes over the global batch (its moments are all-reduced,
with the gradient flowing through the collective, as XLA partitions the JAX
package's batch-sharded step), and drop-connect draws the masks of the
global batch and keeps the process's rows, so a step on W processes is the
step of one process on the global batch.

``compute_dtype`` (float32 by default, or bfloat16) is the JAX package's
``dtype``: the convolutions, their BatchNorm and activations run in it, with
the parameters cast at each use; parameters, BatchNorm running statistics
and gradients stay float32, and BatchNorm computes its statistics and its
normalization in float32 and rounds the result to ``compute_dtype``, as
Flax's ``BatchNorm(dtype=...)`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_epilogue, cuda_mbconv
from ..parallel import mesh


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


def as_dtype(dtype: Union[str, torch.dtype, None]) -> torch.dtype:
    """A compute dtype given by name ("float32", "bfloat16") or as a
    ``torch.dtype``; None is float32. Other types are refused."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else (dtype or torch.float32)
    if dt not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"compute dtype {dtype}: the port computes in float32 or bfloat16")
    return dt


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-3 unless given, Keras momentum 0.99) with the train-mode
    semantics of Flax's ``nn.BatchNorm``; the ``state_dict`` keys of
    ``nn.BatchNorm2d``.

    In train mode it takes the batch mean and the biased variance over (N,
    H, W) in float32 (float64 input stays float64, as in Flax), as E[x^2] -
    E[x]^2 clipped at 0 (Flax's
    ``force_float32_reductions`` and ``use_fast_variance``), all-reduced over
    the ranks when a process group of more than one rank is up; normalizes
    with them in float32 and rounds to the input's dtype; and moves the
    running statistics 0.01 of the way to them (Flax updates ``var`` with the
    biased variance; ``nn.BatchNorm2d`` would take the unbiased one).
    ``num_batches_tracked`` is kept but not counted. In eval mode it is
    ``F.batch_norm`` on the running statistics.

    ``act`` applies swish to the result and ``residual`` is added after it.
    ``fused`` (the trunk's inference path, eval mode only) computes all of
    it in one pass of the epilogue kernel (``ops/cuda_epilogue.bn_act``),
    from the running statistics at the call; otherwise the three are
    separate ops."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__(channels, eps=eps, momentum=0.01)

    def forward(self, x, act: bool = False, residual=None, fused: bool = False):
        if fused:
            return cuda_epilogue.bn_act(x, self.running_mean, self.running_var, self.weight, self.bias,
                                        self.eps, act, residual)
        if not self.training:
            return cuda_epilogue.bn_act_plain(x, self.running_mean, self.running_var, self.weight,
                                              self.bias, self.eps, act, residual)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least float32, as Flax
        moments = torch.cat([xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))])
        world = mesh.world_size()
        if world > 1:
            moments = dist_nn.all_reduce(moments) / world
        mean, mean2 = moments.split(self.num_features)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        y = y.to(x.dtype)
        if act:
            y = F.silu(y)
        return y if residual is None else y + residual


def rows_conv(x: torch.Tensor, weight: torch.Tensor, bias, stride) -> torch.Tensor:
    """A dense (groups 1), unpadded convolution of channels_last ``x`` as
    one matrix product over its (N*H*W, C) rows; the result is
    channels_last. A 1x1 convolution multiplies the rows as they lie in
    memory; a larger kernel (the stem's 3x3 on one channel at stride 2,
    padded before by ``correct_pad``) multiplies its patches, gathered into
    rows by one copy. cuDNN runs these shapes in float32 with kernels for
    NCHW, which on channels_last data transpose the input and the output;
    ``F.unfold`` would launch one kernel a sample."""
    o, c, kh, kw = weight.shape
    patches = x.unfold(2, kh, stride[0]).unfold(3, kw, stride[1])  # (N, C, oh, ow, kh, kw), a view
    n, _, oh, ow = patches.shape[:4]
    rows = patches.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, c * kh * kw)
    y = F.linear(rows, weight.reshape(o, c * kh * kw), bias)
    return y.view(n, oh, ow, o).permute(0, 3, 1, 2)


class Conv(nn.Conv2d):
    """Conv2d with Flax padding: SAME at stride 1 (odd kernels), Keras
    correct_pad then VALID at stride 2; it computes in its input's dtype.
    ``fused`` (the trunk's inference path) runs a dense, unpadded float32
    convolution (the 1x1s and the stem) as a matrix product over the
    channels_last rows (``rows_conv``); bfloat16 keeps cuDNN's, which round once after a float32 sum (cuBLAS
    may reduce a bfloat16 product's partial sums in bfloat16)."""

    def __init__(self, cin, cout, kernel, strides=1, groups=1, bias=False):
        super().__init__(
            cin, cout, kernel, stride=strides, groups=groups, bias=bias,
            padding=kernel // 2 if strides == 1 else 0,
        )

    def forward(self, x, fused: bool = False):
        if self.stride[0] == 2:
            x = F.pad(x, correct_pad(x.shape[-2:], self.kernel_size[0]))
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if fused and self.groups == 1 and not any(self.padding) and x.dtype == torch.float32:
            return rows_conv(x, self.weight.to(x.dtype), bias, self.stride)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, kernel, strides=1, use_act=True):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, strides)
        self.bn = BatchNorm(cout)
        self.use_act = use_act

    def forward(self, x, fused: bool = False):
        return self.bn(self.conv(x, fused), act=self.use_act, fused=fused)


def drop_connect(x, rate: float, generator) -> torch.Tensor:
    """Zero each sample's x with probability ``rate``, scale the rest by
    1/(1 - rate); the draws come from ``generator`` (on its own device; the
    mask moves to x's). Under a process group of W > 1 ranks, x holds this
    rank's rows of a global batch of W * len(x): the masks of the whole
    global batch are drawn and the rank's rows kept."""
    if generator is None:
        raise ValueError("drop-connect in train mode needs drop_generator (a torch.Generator)")
    keep = 1.0 - rate
    n = x.shape[0]
    draws = torch.rand((n * mesh.world_size(), 1, 1, 1), generator=generator, device=generator.device)
    mask = draws[mesh.local_rows(draws.shape[0])].to(x.device) < keep
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
            self.expand_bn = BatchNorm(expanded)
        self.dw_conv = Conv(expanded, expanded, args.kernel_size, strides, groups=expanded)
        self.dw_bn = BatchNorm(expanded)
        self.has_se = bool(args.se_ratio and args.se_ratio > 0)
        if self.has_se:
            se_filters = max(1, int(filters_in * args.se_ratio))
            self.se_reduce = Conv(expanded, se_filters, 1, bias=True)
            self.se_expand = Conv(se_filters, expanded, 1, bias=True)
        self.project_conv = Conv(expanded, filters_out, 1)
        self.project_bn = BatchNorm(filters_out)

    def forward(self, x, drop_generator=None, fused: bool = False):
        inputs = x
        if fused and self.has_se and x.dtype == torch.float32:
            # the expand product's raw output (or the block's input) through the middle kernel
            x = cuda_mbconv.mbconv_middle(self.expand_conv(x, fused) if self.args.expand_ratio != 1 else x,
                                          *self.middle_args())
        else:
            if self.args.expand_ratio != 1:
                x = self.expand_bn(self.expand_conv(x, fused), act=True, fused=fused)
            x = self.dw_bn(self.dw_conv(x), act=True, fused=fused)
            if self.has_se:
                se = x.mean(dim=(-2, -1), keepdim=True)
                se = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(se, fused)), fused))
                x = x * se
        x = self.project_conv(x, fused)
        if not self.residual:
            return self.project_bn(x, fused=fused)
        if self.training and self.drop_rate > 0:
            return drop_connect(self.project_bn(x), self.drop_rate, drop_generator) + inputs
        return self.project_bn(x, residual=inputs, fused=fused)

    def middle_args(self):
        """``ops/cuda_mbconv.mbconv_middle``'s arguments after its input: the
        expand BatchNorm (None where the block does not expand), the
        depthwise weight and stride, the depthwise BatchNorm, the SE
        products."""
        def bn(m):
            return cuda_mbconv.BN(m.running_mean, m.running_var, m.weight, m.bias, m.eps)

        return (bn(self.expand_bn) if self.args.expand_ratio != 1 else None, self.dw_conv.weight,
                self.dw_conv.stride[0], bn(self.dw_bn),
                cuda_mbconv.SE(self.se_reduce.weight, self.se_reduce.bias, self.se_expand.weight,
                               self.se_expand.bias))


def _on_card(x: torch.Tensor) -> bool:
    """The inference path's device test (the CPU tests substitute it)."""
    return x.is_cuda


class EfficientNet(nn.Module):
    """EfficientNet trunk (no pooling/top). Input NHWC (B, H, W, 1) float32;
    returns the (N, C, H, W) feature map of the ``top`` layer (stored
    channels_last) in ``compute_dtype``
    (an attribute, "float32" or "bfloat16"). It takes features, not
    waveforms (``takes_waveform``); the embedding head pools its map over
    H and W (``pool_dims``)."""

    takes_waveform = False
    pool_dims = (-2, -1)

    def __init__(
        self,
        width_coefficient: float = 1.0,
        depth_coefficient: float = 1.0,
        drop_connect_rate: float = 0.2,
        blocks: Tuple[BlockArgs, ...] = DEFAULT_BLOCKS,
        input_scale: float = 1.0 / 255.0,
        input_bias: float = 0.0,
        compute_dtype: Union[str, torch.dtype, None] = None,
    ):
        super().__init__()
        self.width_coefficient = width_coefficient
        self.depth_coefficient = depth_coefficient
        self.input_scale = input_scale
        self.input_bias = input_bias
        self.compute_dtype = as_dtype(compute_dtype)
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

    def inference_path(self, x: torch.Tensor) -> bool:
        """Whether a forward on ``x`` takes the fused epilogue: eval mode,
        ``x`` on the card, and autograd recording nothing in the trunk
        (grad mode off, or neither ``x`` nor any trunk parameter requires
        grad)."""
        records = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *self.parameters()))
        return not self.training and _on_card(x) and not records

    def forward(self, x, drop_generator=None):
        fused = self.inference_path(x)
        x = (x * self.input_scale + self.input_bias).to(self.compute_dtype)
        x = x.permute(0, 3, 1, 2)  # NHWC -> (N, C, H, W), channels_last strides
        x = self.stem(x, fused)
        for name in self.block_names:
            x = getattr(self, name)(x, drop_generator, fused)
        return self.top(x, fused)


def EfficientNetB0(**kw) -> EfficientNet:
    return EfficientNet(width_coefficient=1.0, depth_coefficient=1.0, **kw)


def EfficientNetB1(**kw) -> EfficientNet:
    return EfficientNet(width_coefficient=1.0, depth_coefficient=1.1, **kw)


def EfficientNetB2(**kw) -> EfficientNet:
    return EfficientNet(width_coefficient=1.1, depth_coefficient=1.2, **kw)
