"""The middle of the B0 trunk's MBConv block on the float32 inference path:
the expand BatchNorm and swish (on load), the depthwise convolution with its
zero halo, its BatchNorm and swish, the squeeze-excitation mean, its two
products with silu and sigmoid, and the gate multiply, as one CUDA kernel
over a channels_last activation; and its plain PyTorch version.

Replaces no Pallas kernel (XLA fused these stages into the TPU's
convolutions). On the card it replaces what the inference path launched
between a block's expand and project products: the expand ``bn_act``, the
stride-2 pad, cuDNN's depthwise convolution, the depthwise ``bn_act``, the
SE mean, two small products, silu, sigmoid and the gate multiply, seven
passes over the expanded tensor, by one read of the block's input and one
write of its gated output (``mbconv_middle`` in ``csrc/mbconv.cu``, whose
note gives the design). Its bound is bytes: the trunk's 16 blocks read
178,144 and write 118,048 float32 values a 49 x 40 window, 2.90 ms at
8,192 windows and 3.35 TB/s; on an H100 it is held by latency and
instruction issue at about five times that.

``mbconv_middle(x, expand_bn, dw_weight, stride, dw_bn, se)``: on a CUDA
tensor the kernel (float32, channels_last, four dimensions, no autograd:
it raises otherwise); on a CPU tensor ``mbconv_middle_plain``, the module
path's ops. ``x`` is the expand product's raw output (``expand_bn`` its
BatchNorm), or the block's input where the block does not expand
(``expand_bn`` None). The kernel reads the statistics and parameters at
every call, so a state loaded into the modules later is read by the next
call.

How it launches follows from the shapes and the card alone
(``launch_plan``): where the batch gives every SM a block of threads of
whole samples, one launch takes whole samples (up to ``MAX_GROUP`` a block
of threads where a block's parameters outweigh a sample's activations, so
that each weight read serves several samples); a smaller batch (the
fine-tune's 64, the live feed's 1-5) takes the split form, a launch a
(sample, chunk of channels) and a launch a sample for the SE and the gate.
Float32 only, with the fast float32 exp and divide in swish and sigmoid
(a few ulps): bfloat16 keeps the module path.
``mbconv_middle`` counts every call, ``mbconv_middle_split`` the calls that
took the split form (``_build.counted``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

THREADS = 256  # a block of threads (csrc/mbconv.cu kThreads)
ROWS = 4  # output rows a thread computes at once (kRows)
MAX_GROUP = 8  # samples a block of threads takes at most (kMaxGroup)
# a block of threads takes several samples where a block's parameters outweigh
# a sample's activations this many times (the blocks with 2 x 2 outputs: 6 to
# 17 times; on an H100, groups of 3-4 made the 4 x 3 blocks, 3 to 4 times, no
# faster or slower)
GROUP_RATIO = 5
# input values a round of the kernel loads, about: 16 a thread (on an H100,
# rounds of 2,048, 8,192 or 16,384 took the 16 blocks 17.5, 18.9, 14.3 ms
# against 14.6 ms, the last only where it fits: 4,096 is the one size)
LOAD_VALUES = 4096
SMEM_LIMIT = 227 * 1024  # shared memory a block of threads may use on Hopper


class BN(NamedTuple):
    """An eval-mode BatchNorm: running statistics, affine parameters, eps."""

    mean: torch.Tensor
    var: torch.Tensor
    weight: torch.Tensor
    bias: torch.Tensor
    eps: float


class SE(NamedTuple):
    """The squeeze-excitation products: ``se_reduce`` (se, E, 1, 1) with its
    bias, ``se_expand`` (E, se, 1, 1) with its bias."""

    reduce_weight: torch.Tensor
    reduce_bias: torch.Tensor
    expand_weight: torch.Tensor
    expand_bias: torch.Tensor


class Plan(NamedTuple):
    lanes: int  # threads a channel in the taps (THREADS // lanes channels a round)
    group: int  # samples a block of threads
    split: bool
    pad: bool  # whether the input planes carry their zero halo (where it costs little)
    wp: int  # width of a sample's input plane in shared memory: win, or with the halo
    pp: int  # its size: hin x win, or rows that cover every tap of every item x wp
    psg: int  # a channel's input planes: the samples a round loads x pp, made odd
    osg: int  # a channel's output planes: the same samples x hout x wout, made odd


def pads(h: int, w: int, k: int, stride: int):
    """(top, left, output height, output width) of the depthwise convolution:
    SAME at stride 1; at stride 2 Keras' ``correct_pad`` (the trunk's
    ``efficientnet.correct_pad``), then VALID."""
    c = k // 2
    if stride == 1:
        return c, c, h, w
    top, left = c - (1 - h % 2), c - (1 - w % 2)
    return top, left, (h + top + c - k) // 2 + 1, (w + left + c - k) // 2 + 1


def launch_plan(n: int, e: int, se: int, k: int, stride: int, hin: int, win: int, sms: int) -> Plan:
    """How the kernel takes a batch of ``n`` samples of ``e`` channels
    (hin x win, a k x k depthwise kernel at ``stride``, ``se`` SE channels)
    on a card of ``sms`` SMs. A block of threads takes ``group`` samples
    where the block's parameters outweigh a sample's activations
    GROUP_RATIO times or more: as many as they outweigh them, at most
    MAX_GROUP and n // sms, so that each SE weight it reads serves each of
    them. A round loads about LOAD_VALUES input values of them: as many
    channels as that takes (the nearest power of two, 8 to THREADS), each
    with THREADS / channels threads. The per-sample form needs n >= sms,
    so that every SM has a block of threads; a smaller batch takes the
    split form (a block of threads a sample and chunk, then one a sample).
    Raises where the rounds do not fit in shared memory."""
    _, _, hout, wout = pads(hin, win, k, stride)
    hw_in, hw_out = hin * win, hout * wout
    split = n < sms
    ratio = -(-(e * (k * k + 2 * se + 8) + se) // (e * (hw_in + hw_out)))  # parameters / activations
    group = 1 if split or ratio < GROUP_RATIO else min(MAX_GROUP, ratio, n // sms)
    # a plane with its zero halo lets the taps test no bounds; it holds every
    # row an item of ROWS output rows reads, and is taken where that costs at
    # most twice the plane's pixels (the large planes of the early blocks)
    wp = (wout - 1) * stride + k
    pp = ((-(-hout // ROWS) * ROWS - 1) * stride + k) * wp
    pad = pp <= 2 * hw_in
    if not pad:
        wp, pp = win, hw_in
    while True:
        rows = 1 if split else group  # samples a round loads
        chunk = min(THREADS, max(THREADS // 32, 1 << max(0, round(math.log2(LOAD_VALUES / (rows * hw_in))))))
        psg, osg = (rows * pp) | 1, (rows * hw_out) | 1
        if 4 * (chunk * (2 * psg + osg) + -(-group * e // 4) * 4 + group * se) <= SMEM_LIMIT:
            return Plan(THREADS // chunk, group, split, pad, wp, pp, psg, osg)
        if group == 1:
            raise ValueError(f"mbconv_middle: {e} channels of {hin} x {win} do not fit in shared memory")
        group -= 1


def mbconv_middle_plain(x: torch.Tensor, expand_bn: Optional[BN], dw_weight: torch.Tensor, stride: int,
                        dw_bn: BN, se: SE) -> torch.Tensor:
    """Plain version, the module path's ops: ``F.batch_norm`` and ``F.silu``
    (if ``expand_bn``), the pad and the depthwise ``F.conv2d``,
    ``F.batch_norm`` and ``F.silu``, the mean over H and W, the two 1x1
    ``F.conv2d`` with silu and sigmoid, the gate multiply; any device."""
    if expand_bn is not None:
        x = F.silu(F.batch_norm(x, expand_bn.mean, expand_bn.var, expand_bn.weight, expand_bn.bias,
                                False, 0.0, expand_bn.eps))
    k = dw_weight.shape[-1]
    top, left, _, _ = pads(x.shape[-2], x.shape[-1], k, stride)
    if stride == 2:
        x = F.pad(x, (left, k // 2, top, k // 2))
        x = F.conv2d(x, dw_weight, None, stride, 0, 1, x.shape[1])
    else:
        x = F.conv2d(x, dw_weight, None, stride, k // 2, 1, x.shape[1])
    x = F.silu(F.batch_norm(x, dw_bn.mean, dw_bn.var, dw_bn.weight, dw_bn.bias, False, 0.0, dw_bn.eps))
    s = x.mean(dim=(-2, -1), keepdim=True)
    s = torch.sigmoid(F.conv2d(F.silu(F.conv2d(s, se.reduce_weight, se.reduce_bias)),
                               se.expand_weight, se.expand_bias))
    return x * s


def check(x: torch.Tensor, expand_bn: Optional[BN], dw_weight: torch.Tensor, stride: int, dw_bn: BN,
          se: SE) -> None:
    """Raise unless the kernel takes the call: float32, channels_last x,
    a 3 or 5 depthwise kernel at stride 1 or 2, every parameter contiguous
    float32 of its shape on x's device, and autograd recording nothing."""
    if x.dtype != torch.float32:
        raise TypeError(f"mbconv_middle takes float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"mbconv_middle takes a channels_last (N, C, H, W) tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    e = x.shape[1]
    k = dw_weight.shape[-1]
    if k not in (3, 5) or stride not in (1, 2) or tuple(dw_weight.shape) != (e, 1, k, k):
        raise ValueError(f"mbconv_middle: a depthwise kernel of 3 or 5 at stride 1 or 2 over {e} channels, "
                         f"got {tuple(dw_weight.shape)} at stride {stride}")
    se_n = se.reduce_weight.shape[0]
    shapes = {"dw_weight": (dw_weight, (e, 1, k, k)),
              "se.reduce_weight": (se.reduce_weight, (se_n, e, 1, 1)), "se.reduce_bias": (se.reduce_bias, (se_n,)),
              "se.expand_weight": (se.expand_weight, (e, se_n, 1, 1)), "se.expand_bias": (se.expand_bias, (e,))}
    for name, bn in (("expand_bn", expand_bn), ("dw_bn", dw_bn)):
        if bn is not None:
            shapes.update({f"{name}.{f}": (getattr(bn, f), (e,)) for f in ("mean", "var", "weight", "bias")})
    for name, (p, shape) in shapes.items():
        if (p.dtype != torch.float32 or tuple(p.shape) != shape or not p.is_contiguous()
                or p.device != x.device):
            raise ValueError(f"mbconv_middle: {name} must be contiguous float32 {shape} on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *(p for p, _ in shapes.values()))):
        raise RuntimeError("mbconv_middle has no backward: call it where autograd records nothing")


def mbconv_middle(x: torch.Tensor, expand_bn: Optional[BN], dw_weight: torch.Tensor, stride: int,
                  dw_bn: BN, se: SE) -> torch.Tensor:
    """The block's middle on channels_last ``x`` (N, E, H, W): kernel on
    CUDA tensors, in the form ``launch_plan`` chooses; plain version on CPU
    tensors. Returns the gated (N, E, H', W'), channels_last."""
    if x.device.type == "cpu":
        return mbconv_middle_plain(x, expand_bn, dw_weight, stride, dw_bn, se)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv_middle: unsupported device {x.device}")
    check(x, expand_bn, dw_weight, stride, dw_bn, se)
    n, e, h, w = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = launch_plan(n, e, se.reduce_weight.shape[0], dw_weight.shape[-1], stride, h, w, sms)
    out = (mbconv_middle_split if plan.split else launch)(x, expand_bn, dw_weight, stride, dw_bn, se, plan)
    _build.count(mbconv_middle)
    return out


def launch(x: torch.Tensor, expand_bn: Optional[BN], dw_weight: torch.Tensor, stride: int, dw_bn: BN,
           se: SE, plan: Plan) -> torch.Tensor:
    """One call of the kernel on checked tensors, in the form ``plan`` gives
    (``mbconv_middle`` chooses it; the card tests give both forms)."""
    n, e, h, w = x.shape
    k = dw_weight.shape[-1]
    top, left, hout, wout = pads(h, w, k, stride)
    out = torch.empty((n, e, hout, wout), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    means = torch.empty((n, e), dtype=torch.float32, device=x.device) if plan.split else None
    ebn = (None,) * 4 + (0.0,) if expand_bn is None else tuple(t.data_ptr() for t in expand_bn[:4]) + (expand_bn.eps,)
    lib = _build.load("mbconv")
    with torch.cuda.device(x.device):
        err = lib.kws_mbconv_middle(
            x.data_ptr(), out.data_ptr(), None if means is None else means.data_ptr(),
            *ebn, dw_weight.data_ptr(), *(t.data_ptr() for t in dw_bn[:4]), float(dw_bn.eps),
            *(t.data_ptr() for t in se), n, e, se.reduce_weight.shape[0], h, w, hout, wout, k, stride, top,
            left, plan.lanes, plan.group, int(plan.pad), plan.wp, plan.pp, plan.psg, plan.osg, int(plan.split),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "mbconv_middle")
    return out


def mbconv_middle_split(x: torch.Tensor, expand_bn: Optional[BN], dw_weight: torch.Tensor, stride: int,
                        dw_bn: BN, se: SE, plan: Plan) -> torch.Tensor:
    """``launch`` in the split form, counted apart, so that a run shows
    which form its calls took."""
    out = launch(x, expand_bn, dw_weight, stride, dw_bn, se, plan)
    _build.count(mbconv_middle_split)
    return out


_build.counted(mbconv_middle)
_build.counted(mbconv_middle_split)
