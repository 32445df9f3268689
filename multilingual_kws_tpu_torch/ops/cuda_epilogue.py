"""The B0 trunk's inference epilogue: eval-mode BatchNorm, then optionally
swish, then optionally a residual add, as one CUDA kernel over a
channels_last activation, and its plain PyTorch version.

Replaces no Pallas kernel (XLA fused these stages into the TPU's
convolutions). On the card it replaces what the module path launches after
each convolution of the trunk's inference forward: cuDNN's BatchNorm
inference, ``F.silu`` and the residual add, three passes over the
activation, by one (``bn_act`` in ``csrc/epilogue.cu``, whose note gives
the design). It is bound by bytes: 8 bytes read and written per float32
value (12 with the residual) for ~6 float operations. Its float32
BatchNorm is PyTorch's CPU formula (cuDNN's, which the module path runs on
the card, is not public; they differ by float32 rounding); its bfloat16
BatchNorm is the formula of PyTorch's channels_last kernel, which the
module path runs on the card, so there the two are equal bit for bit.

``bn_act(x, mean, var, weight, bias, eps, act, residual)``: on a CUDA
tensor the kernel (float32 or bfloat16, channels_last, four dimensions, no
autograd: it raises otherwise); on a CPU tensor ``bn_act_plain``, the
module path's ops: ``F.batch_norm`` on the running statistics, then
``F.silu``, then ``+ residual``. The kernel computes the scale and shift
from the statistics at every call, so a state loaded into the module later
is read by the next call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, eps: float, act: bool = False,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: eval-mode ``F.batch_norm``, then ``F.silu`` if
    ``act``, then ``+ residual`` if given; any device and layout."""
    y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
    if act:
        y = F.silu(y)
    return y if residual is None else y + residual


def _check(x, mean, var, weight, bias, residual):
    if x.device.type != "cuda":
        raise ValueError(f"bn_act: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"bn_act takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bn_act takes a channels_last (N, C, H, W) tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    for name, p in (("mean", mean), ("var", var), ("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (x.shape[1],) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"bn_act: {name} must be float32 ({x.shape[1]},) on {x.device}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or residual.stride() != x.stride()):
        raise ValueError("bn_act: the residual must have x's shape, dtype, device and strides")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias, residual)):
        raise RuntimeError("bn_act has no backward: call it where autograd records nothing")


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor, eps: float, act: bool = False,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval-mode BatchNorm of channels_last ``x`` (N, C, H, W) with the
    running statistics ``mean``, ``var`` and the affine ``weight``,
    ``bias``; then swish if ``act``; then ``+ residual``. Kernel on CUDA
    tensors, plain version on CPU tensors."""
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, var, weight, bias, eps, act, residual)
    _check(x, mean, var, weight, bias, residual)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    n, c, h, w = x.shape
    lib = _build.load("epilogue")
    with torch.cuda.device(x.device):
        err = lib.kws_bn_act(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            mean.data_ptr(), var.data_ptr(), weight.data_ptr(), bias.data_ptr(), float(eps),
            n * h * w, c, DTYPES[x.dtype], int(act), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "bn_act")
    _build.count(bn_act)
    return out


_build.counted(bn_act)
