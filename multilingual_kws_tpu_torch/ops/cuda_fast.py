"""The fast mode's noise-estimate recurrence, as one CUDA kernel and its
plain PyTorch version.

Replaces ``multilingual_kws_tpu/ops/pallas_frontend.py::noise_estimate_scan``
(the Pallas kernel ``_nr_kernel``): est_t = floor((sig_t * sb * sm +
est_{t-1} * om) / 2^14) on integer-valued float32, carried from 0. The
kernel is ``noise_scan_f32`` in ``csrc/fast.cu``.

``noise_scan_f32(base, n, stride, F, frontend)`` follows
``cuda_frontend.stream_suffix``'s contract: window w covers rows
``w*stride .. w*stride+F-1`` of the float32 ``base`` (R, C) and restarts the
estimate at its first row; it returns the (n, F, C) estimate sequence.
Streams use stride 1, clip batches stride F: neither gathers the windows.

The float semantics are XLA's, which contracts the recurrence into one fused
multiply-add: fma(sig * sb, sm, est * om), then the division and the floor.
The kernel writes exactly that with ``__f*_rn`` intrinsics (nvcc contracts
nothing else); the plain version rounds the sum once through float64.

On the card the kernel is bound by bytes: it writes 4 bytes per (window,
frame, channel) for 6 float operations. One thread per (window, channel)
carries the estimate in a register; neighbouring threads are neighbouring
channels, so reads and writes coalesce. The pointwise stages after it
(``micro_fast.nr_pcan_log_fast``) stay plain PyTorch, so that the card and
the CPU run one definition of them.
"""

from __future__ import annotations

import torch

from . import _build
from .micro_exact import NOISE_REDUCTION_BITS
from .micro_fast import _fma, windows_view


def _check_windows(base, num_windows, stride, frames, fe):
    if base.dim() != 2:
        raise ValueError(f"noise_scan_f32 takes (rows, channels), got {tuple(base.shape)}")
    if num_windows > 0 and (num_windows - 1) * stride + frames > base.shape[0]:
        raise ValueError(
            f"{num_windows} windows of {frames} rows at stride {stride} overrun {base.shape[0]} rows"
        )
    if base.shape[1] != fe.num_channels:
        raise ValueError(f"noise_scan_f32: {base.shape[1]} channels, frontend has {fe.num_channels}")


def noise_scan_f32_plain(base: torch.Tensor, num_windows: int, stride: int, frames: int, fe) -> torch.Tensor:
    """Plain version: (R, C) float32 -> (num_windows, frames, C) float32
    estimates, a loop over frames; any device."""
    _check_windows(base, num_windows, stride, frames, fe)
    tb = fe.fast_tables(base.device)
    sb = float(1 << fe.smoothing_bits)
    nrb = float(1 << NOISE_REDUCTION_BITS)
    x = windows_view(base.to(torch.float32), num_windows, stride, frames)
    out = torch.empty(x.shape, dtype=torch.float32, device=base.device)
    est = x.new_zeros((x.shape[0], x.shape[2]))
    for t in range(frames):
        est = torch.floor(_fma(x[:, t] * sb, tb["sm"], (est * tb["om"]).to(torch.float64)) / nrb)
        out[:, t] = est
    return out


def noise_scan_f32(base: torch.Tensor, num_windows: int, stride: int, frames: int, fe) -> torch.Tensor:
    """(R, C) float32 signal -> (num_windows, frames, C) float32 estimates.
    Kernel on CUDA tensors, plain version on CPU tensors."""
    if base.device.type == "cpu":
        return noise_scan_f32_plain(base, num_windows, stride, frames, fe)
    _check_windows(base, num_windows, stride, frames, fe)
    if base.device.type != "cuda":
        raise ValueError(f"noise_scan_f32: unsupported device {base.device}")
    if base.dtype != torch.float32 or not base.is_contiguous():
        raise TypeError(f"noise_scan_f32 takes contiguous float32 rows, got {base.dtype}")
    c = base.shape[1]
    out = torch.empty((num_windows, frames, c), dtype=torch.float32, device=base.device)
    if out.numel() == 0:
        return out
    tb = fe.fast_tables(base.device)
    lib = _build.load("fast")
    with torch.cuda.device(base.device):
        err = lib.kws_noise_scan_f32(
            base.data_ptr(), num_windows, stride, frames, c,
            tb["sm"].data_ptr(), tb["om"].data_ptr(),
            float(1 << fe.smoothing_bits), float(1 << NOISE_REDUCTION_BITS),
            out.data_ptr(), torch.cuda.current_stream(base.device).cuda_stream,
        )
    _build.check(lib, err, "noise_scan_f32")
    _build.count(noise_scan_f32)
    return out


_build.counted(noise_scan_f32)
