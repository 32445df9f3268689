"""The stream prefix: framing, window, input shift, kiss FFT, energies,
filterbank and Sqrt64, as one CUDA kernel and its plain PyTorch version.

Replaces ``multilingual_kws_tpu/ops/pallas_fft.py::window_fft_energy`` (the
Pallas kernel ``_window_fft_energy_kernel``) together with the exact
filterbank and ``sqrt64_exact`` epilogue that ``micro_jax.base_frames``
runs after it. The kernel is ``stream_prefix`` in ``csrc/frontend.cu``.

``stream_prefix(audio, frontend)``: (B, samples) int16 -> (B, F, C)
int32 sqrt-filterbank signal. On a CUDA tensor it launches the kernel (or
raises); on a CPU tensor it runs ``stream_prefix_plain``.

On the card the kernel is bound by integer operations (~28k per 20 ms frame
against ~1 KB of audio in and results out). A frame's FFT substate and its
energies stay in shared memory, 64 threads per frame, one radix-4 butterfly
each per stage; the source note in ``csrc/frontend.cu`` has the rest.
"""

from __future__ import annotations

import torch

from . import _build
from . import micro_int as mi
from .micro_exact import WINDOW_BITS


def stream_prefix_plain(audio: torch.Tensor, fe) -> torch.Tensor:
    """Plain version: (B, samples) int -> (B, F, C) int32, on any device.
    ``fe`` is a ``micro_torch.MicroFrontendTorch`` (tables and kiss FFT)."""
    b, t = audio.shape
    nf = fe.num_frames(t)
    tb = fe.tables(audio.device)
    if nf == 0:
        return torch.zeros((b, 0, fe.num_channels), dtype=torch.int32, device=audio.device)
    win, step = fe.window_size, fe.window_step
    idx = (
        torch.arange(nf, device=audio.device)[:, None] * step
        + torch.arange(win, device=audio.device)[None, :]
    )
    frames = audio.to(torch.int64)[:, idx]  # (B, F, win)
    windowed = (frames * tb["window"]) >> WINDOW_BITS
    max_abs = windowed.abs().amax(dim=-1)
    shift = (15 - mi.msb32(max_abs)).clamp(0, 15)
    scaled = windowed * (torch.ones_like(shift) << shift)[..., None]
    fft_in = torch.nn.functional.pad(scaled, (0, 512 - win))
    fr, fi = fe.kiss(fft_in)
    energy = (fr * fr + fi * fi) & mi.U32  # uint32 wrap, as in C
    acc = mi.filterbank_accumulate(energy, tb["fb_idx"], tb["fb_wgt"])
    return (mi.sqrt64_exact(acc) >> shift[..., None]).to(torch.int32)


def stream_prefix(audio: torch.Tensor, fe) -> torch.Tensor:
    """(B, samples) int16 -> (B, F, C) int32. Kernel on CUDA tensors, plain
    version on CPU tensors."""
    if audio.dim() != 2:
        raise ValueError(f"stream_prefix takes (batch, samples), got {tuple(audio.shape)}")
    if audio.device.type == "cpu":
        return stream_prefix_plain(audio, fe)
    if audio.device.type != "cuda":
        raise ValueError(f"stream_prefix: unsupported device {audio.device}")
    if audio.dtype != torch.int16:
        raise TypeError(f"stream_prefix takes int16 audio, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("stream_prefix takes contiguous audio")
    b, t = audio.shape
    nf = fe.num_frames(t)
    c = fe.num_channels
    out = torch.empty((b, nf, c), dtype=torch.int32, device=audio.device)
    if b == 0 or nf == 0:
        return out
    if fe.window_size > 512 or fe.window_size <= 256:
        raise ValueError(f"stream_prefix is built for a 512-point FFT, window {fe.window_size}")
    tb = fe.tables(audio.device, torch.int32)
    lib = _build.load("frontend")
    with torch.cuda.device(audio.device):
        err = lib.kws_stream_prefix(
            audio.data_ptr(), b, t, nf,
            fe.window_size, fe.window_step, c, tb["fb_idx"].shape[1],
            tb["window"].data_ptr(), tb["tw_r"].data_ptr(), tb["tw_i"].data_ptr(),
            tb["stw_r"].data_ptr(), tb["stw_i"].data_ptr(),
            tb["fb_idx"].data_ptr(), tb["fb_wgt"].data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(audio.device).cuda_stream,
        )
    _build.check(lib, err, "stream_prefix")
    stream_prefix.launches += 1
    return out


stream_prefix.launches = 0
