"""The stream suffix: per-window noise estimate, noise subtraction, PCAN and
log, as one CUDA kernel and its plain PyTorch version.

Replaces ``multilingual_kws_tpu/ops/pallas_frontend.py::noise_estimate_scan_u32``
(the Pallas kernel ``_nr_kernel_u32``) together with the pointwise stages
that ``micro_jax.nr_pcan_log_int`` runs after it, and the ``(W, 49, 40)``
window gather of ``micro_jax._stream_impl`` before it: the kernel reads
rows ``start .. start+F-1`` of the base signal for each window itself. It
is ``stream_suffix`` in ``csrc/frontend.cu``.

``stream_suffix(base, n, stride, F, frontend)``: window w covers rows
``w*stride .. w*stride+F-1`` of ``base`` (R, C) and restarts the noise
state at its first row. Streams use stride 1 (a window per hop); clip
batches use stride F (one window per clip).

On the card the kernel is bound by integer instructions, not bytes: at the
data sheet its 52 operations an element take longer than its (W, 49, 40)
output and the base rows it reads, and the compiled loop issues more
instructions than that (its SASS census, ``probes/sass.py``). A thread
takes ``cpt`` consecutive channels of one window (``launch_plan``: four on
streams of more than about 8,400 windows, one where fewer leave the card
idle), keeps their carries in registers and writes each feature once; the
source note in ``csrc/frontend.cu`` has the rest.
"""

from __future__ import annotations

import torch

from . import _build
from . import micro_int as mi

FEATURE_SCALE = 10.0 / 256.0  # reference to_micro_spectrogram output scale
# the launch plan's switch point: four channels a thread from this many of
# that layout's threads per SM (where the two layouts' times cross in
# chip_smoke.py phase d)
FOUR_FROM_THREADS_PER_SM = 640


def noise_estimate_chain_plain(x: torch.Tensor, fe) -> torch.Tensor:
    """(..., F, C) int64 signal -> (..., F, C) int64 noise estimate after each
    frame, from 0: the suffix's only serial part (``noise_step`` in
    ``csrc/frontend.cu``)."""
    tb = fe.tables(x.device)
    est = mi.noise_estimate_scan_u32(x.movedim(-2, 0), tb["sm"], tb["om"], fe.smoothing_bits)
    return est.movedim(0, -2)


def suffix_pointwise_plain(x: torch.Tensor, est: torch.Tensor, fe) -> torch.Tensor:
    """(..., F, C) int64 signal and its noise estimate -> int64 integer
    features: noise subtraction, PCAN gain and log (or the 16-bit cap), each
    element from its own (signal, estimate) (``suffix_pointwise`` in
    ``csrc/frontend.cu``)."""
    tb = fe.tables(x.device)
    out = mi.nr_subtract(x, est, fe.min_signal_remaining, fe.smoothing_bits)
    if fe.enable_pcan:
        gain = mi.wide_dynamic_function(est, tb["wdf_rows"], tb["lut012"])
        out = mi.pcan_gain(out, gain, fe.snr_shift)
    if fe.enable_log:
        return mi.log_scale_int(out, fe.correction_bits, fe.scale_shift, tb["log_lut"])
    return out.clamp(max=0xFFFF)


def nr_pcan_log_plain(x: torch.Tensor, fe) -> torch.Tensor:
    """(W, F, C) sqrt-filterbank signal -> (W, F, C) int64 integer features."""
    x = x.to(torch.int64)
    return suffix_pointwise_plain(x, noise_estimate_chain_plain(x, fe), fe)


def scale_features(raw: torch.Tensor, scaled: bool) -> torch.Tensor:
    """int64 integer features -> float32 on the 10/256 scale, or int32."""
    return raw.to(torch.float32) * FEATURE_SCALE if scaled else raw.to(torch.int32)


def stream_suffix_plain(base, num_windows: int, stride: int, frames: int, fe, scaled: bool = True):
    """Plain version: gather the windows, then the suffix; int32 raw
    features or float32 features on the 10/256 scale."""
    idx = (
        torch.arange(num_windows, device=base.device)[:, None] * stride
        + torch.arange(frames, device=base.device)[None, :]
    )
    return scale_features(nr_pcan_log_plain(base[idx], fe), scaled)


def _check_windows(base: torch.Tensor, num_windows: int, stride: int, frames: int) -> None:
    if base.dim() != 2:
        raise ValueError(f"stream_suffix takes (rows, channels), got {tuple(base.shape)}")
    if num_windows > 0 and (num_windows - 1) * stride + frames > base.shape[0]:
        raise ValueError(
            f"{num_windows} windows of {frames} rows at stride {stride} overrun {base.shape[0]} rows"
        )


def launch_plan(num_windows: int, channels: int, sms: int) -> int:
    """Channels per thread of a ``stream_suffix`` launch on a card of
    ``sms`` SMs: thread i takes window i // (channels / cpt) and channels
    cpt * (i % (channels / cpt)) onwards, so each (window, channel) once.
    Four where that layout still has ``FOUR_FROM_THREADS_PER_SM`` threads an
    SM (16-byte loads and stores, a quarter of the threads' fixed work);
    else one, so that few windows, down to one long clip, spread over the
    most threads (their chains' latency, not the issue rate, sets the
    time)."""
    return 4 if channels % 4 == 0 and num_windows * channels // 4 >= FOUR_FROM_THREADS_PER_SM * sms else 1


def stream_suffix(base: torch.Tensor, num_windows: int, stride: int, frames: int, fe, scaled: bool = True):
    """(R, C) int32 base signal -> (num_windows, frames, C) features.
    Kernel on CUDA tensors, plain version on CPU tensors."""
    _check_windows(base, num_windows, stride, frames)
    if base.device.type == "cpu":
        return stream_suffix_plain(base, num_windows, stride, frames, fe, scaled)
    if base.device.type != "cuda":
        raise ValueError(f"stream_suffix: unsupported device {base.device}")
    sms = torch.cuda.get_device_properties(base.device).multi_processor_count
    return launch_suffix(base, num_windows, stride, frames, fe, scaled, launch_plan(num_windows, base.shape[1], sms))


def launch_suffix(base: torch.Tensor, num_windows: int, stride: int, frames: int, fe, scaled: bool, cpt: int):
    """The kernel on a CUDA base with ``cpt`` (1 or 4) channels a thread,
    the plan's choice or, to compare the two, the caller's."""
    _check_windows(base, num_windows, stride, frames)
    if base.dtype != torch.int32 or not base.is_contiguous():
        raise TypeError(f"stream_suffix takes contiguous int32 rows, got {base.dtype}")
    c = base.shape[1]
    if c != fe.num_channels:
        raise ValueError(f"stream_suffix: {c} channels, frontend has {fe.num_channels}")
    out = torch.empty(
        (num_windows, frames, c), dtype=torch.float32 if scaled else torch.int32, device=base.device
    )
    if out.numel() == 0:
        return out
    tb = fe.tables(base.device, torch.int32)
    lib = _build.load("frontend")
    with torch.cuda.device(base.device):
        err = lib.kws_stream_suffix(
            base.data_ptr(), num_windows, stride, frames, c,
            fe.smoothing_bits, fe.min_signal_remaining, int(fe.enable_pcan), fe.snr_shift,
            int(fe.enable_log), fe.correction_bits, fe.scale_shift,
            tb["sm"].data_ptr(), tb["om"].data_ptr(), tb["wdf_rows"].data_ptr(),
            tb["lut012"].data_ptr(), tb["log_lut"].data_ptr(),
            out.data_ptr(), int(scaled), cpt, torch.cuda.current_stream(base.device).cuda_stream,
        )
    _build.check(lib, err, "stream_suffix")
    _build.count(stream_suffix)
    return out


_build.counted(stream_suffix)
