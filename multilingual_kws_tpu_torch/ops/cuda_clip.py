"""The whole exact frontend of a clip batch, as one CUDA kernel and its plain
PyTorch version.

Replaces ``multilingual_kws_tpu/ops/pallas_fft.py::clip_frontend_features``
(the Pallas kernel ``_clip_frontend_full_kernel``): framing, window, kiss
FFT, filterbank, Sqrt64, noise reduction, PCAN and log for each clip, in one
launch. The kernel is ``clip_features`` in ``csrc/frontend.cu``; it runs the
same device code as ``stream_prefix`` and ``stream_suffix`` and keeps each
clip's (F, C) sqrt-filterbank signal in shared memory between the two.

``clip_features(audio, frontend, scaled=True)``: (B, samples) int16 ->
(B, F, C) float32 features on the 10/256 scale, or int32 raw features with
``scaled=False``. On a CUDA tensor it launches the kernel (or raises); on a
CPU tensor it runs ``clip_features_plain``.

On the card the kernel is bound by integer operations (~1.48 M per 1 s clip
against 40 KB in and out). Its first design, one 256-thread block per clip,
was held back by latency: 64 blocks on 132 SMs at the fine-tune's 64 clips,
block barriers inside the prefix, and the whole suffix serial on 40
threads. It now spreads each clip over a thread block cluster of two
blocks (128 blocks at 64 clips): each block runs half of the frames, one
warp per frame with no block barrier inside the prefix; after a cluster
barrier each block takes half of the channels, reads their rows from its
peer's shared memory, runs only the serial noise estimate one thread per
channel, then the pointwise rest (subtraction, PCAN, log, scale) on
every element at once. ``clip_features_plain`` computes in the same order
(``noise_estimate_chain_plain``, then ``suffix_pointwise_plain``). The
source note in ``csrc/frontend.cu`` has the shared-memory and register
budget. Only clips whose (F, C) signal fits ``MAX_BASE_BYTES`` take it
(``fits``): F <= 204 at 40 channels, about 4 s of audio.
"""

from __future__ import annotations

import torch

from . import _build
from .cuda_fft import stream_prefix_plain
from .cuda_frontend import noise_estimate_chain_plain, scale_features, suffix_pointwise_plain

# bytes of (F, C) int32 signal a clip may have to take the kernel
# (kClipMaxBaseBytes in csrc/frontend.cu)
MAX_BASE_BYTES = 32768


def fits(frames: int, channels: int) -> bool:
    """Whether a clip of ``frames`` frames can take the fused kernel."""
    return 0 < frames * channels * 4 <= MAX_BASE_BYTES


def clip_features_plain(audio: torch.Tensor, fe, scaled: bool = True) -> torch.Tensor:
    """Plain version, in the kernel's order: the prefix of every frame, the
    noise estimate down each channel, then the pointwise rest."""
    x = stream_prefix_plain(audio, fe).to(torch.int64)  # (B, F, C)
    est = noise_estimate_chain_plain(x, fe)
    return scale_features(suffix_pointwise_plain(x, est, fe), scaled)


def clip_features(audio: torch.Tensor, fe, scaled: bool = True) -> torch.Tensor:
    """(B, samples) int16 -> (B, F, C) features. Kernel on CUDA tensors,
    plain version on CPU tensors."""
    if audio.dim() != 2:
        raise ValueError(f"clip_features takes (batch, samples), got {tuple(audio.shape)}")
    if audio.device.type == "cpu":
        return clip_features_plain(audio, fe, scaled)
    if audio.device.type != "cuda":
        raise ValueError(f"clip_features: unsupported device {audio.device}")
    if audio.dtype != torch.int16:
        raise TypeError(f"clip_features takes int16 audio, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("clip_features takes contiguous audio")
    b, t = audio.shape
    nf, c = fe.num_frames(t), fe.num_channels
    out = torch.empty(
        (b, nf, c), dtype=torch.float32 if scaled else torch.int32, device=audio.device
    )
    if out.numel() == 0:
        return out
    if not fits(nf, c):
        raise ValueError(f"clip_features: {nf} frames x {c} channels exceed the kernel's {MAX_BASE_BYTES} bytes")
    if fe.window_size > 512 or fe.window_size <= 256:
        raise ValueError(f"clip_features is built for a 512-point FFT, window {fe.window_size}")
    tb = fe.tables(audio.device, torch.int32)
    lib = _build.load("frontend")
    with torch.cuda.device(audio.device):
        err = lib.kws_clip_features(
            audio.data_ptr(), b, t, nf,
            fe.window_size, fe.window_step, c, tb["fb_idx"].shape[1],
            tb["window"].data_ptr(), tb["tw_r"].data_ptr(), tb["tw_i"].data_ptr(),
            tb["stw_r"].data_ptr(), tb["stw_i"].data_ptr(),
            tb["fb_idx"].data_ptr(), tb["fb_wgt"].data_ptr(),
            fe.smoothing_bits, fe.min_signal_remaining, int(fe.enable_pcan), fe.snr_shift,
            int(fe.enable_log), fe.correction_bits, fe.scale_shift,
            tb["sm"].data_ptr(), tb["om"].data_ptr(), tb["wdf_rows"].data_ptr(),
            tb["lut012"].data_ptr(), tb["log_lut"].data_ptr(),
            out.data_ptr(), int(scaled), torch.cuda.current_stream(audio.device).cuda_stream,
        )
    _build.check(lib, err, "clip_features")
    _build.count(clip_features)
    return out


_build.counted(clip_features)
