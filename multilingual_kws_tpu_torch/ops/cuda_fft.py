"""The stream prefix: framing, window, input shift, kiss FFT, energies,
filterbank and Sqrt64, as one CUDA kernel and its plain PyTorch version; and
the FFT and energies alone (``fft_energy``).

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

``fft_energy(xr, xi, frontend)`` replaces ``pallas_fft.py::kiss_fft_energy``
(the Pallas kernel ``_fft_energy_kernel``): (N, 256) int32 x2, the
input-permuted complex substate (even and odd samples, each in base-4
digit-reversed order), -> (N, 257) int32 holding the uint32 energies (C
wrap). Its kernel runs the same device code as ``stream_prefix``'s FFT. It
serves the frontend cost probe (``probes/fft_cost.py``).
"""

from __future__ import annotations

import torch

from . import _build
from . import micro_int as mi
from .micro_exact import WINDOW_BITS


def fft_input(audio: torch.Tensor, fe):
    """(B, samples) int -> the FFT's input (B, F, 512) int64 (framed,
    windowed >>12, shifted left by each frame's input shift, zero-padded)
    and the shifts (B, F)."""
    tb = fe.tables(audio.device)
    nf = fe.num_frames(audio.shape[1])
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
    return torch.nn.functional.pad(scaled, (0, 512 - win)), shift


def stream_prefix_plain(audio: torch.Tensor, fe) -> torch.Tensor:
    """Plain version: (B, samples) int -> (B, F, C) int32, on any device.
    ``fe`` is a ``micro_torch.MicroFrontendTorch`` (tables and kiss FFT)."""
    b, t = audio.shape
    if fe.num_frames(t) == 0:
        return torch.zeros((b, 0, fe.num_channels), dtype=torch.int32, device=audio.device)
    tb = fe.tables(audio.device)
    fft_in, shift = fft_input(audio, fe)
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
    _build.count(stream_prefix)
    return out


_build.counted(stream_prefix)


def _wrap_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 with the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def fft_energy_plain(xr: torch.Tensor, xi: torch.Tensor, fe) -> torch.Tensor:
    """Plain version: ``KissFftrTorch.substate`` and the wrapped energies;
    any device."""
    fr, fi = fe.kiss.substate(xr.to(torch.int64), xi.to(torch.int64))
    return _wrap_int32((fr * fr + fi * fi) & mi.U32)


def fft_energy(xr: torch.Tensor, xi: torch.Tensor, fe) -> torch.Tensor:
    """(N, 256) int32 x2 -> (N, 257) int32 uint32 energies. Kernel on CUDA
    tensors, plain version on CPU tensors."""
    if xr.dim() != 2 or xr.shape != xi.shape or xr.shape[1] != 256:
        raise ValueError(f"fft_energy takes two (rows, 256) arrays, got {tuple(xr.shape)}, {tuple(xi.shape)}")
    if xr.device.type == "cpu":
        return fft_energy_plain(xr, xi, fe)
    if xr.device.type != "cuda":
        raise ValueError(f"fft_energy: unsupported device {xr.device}")
    if xr.dtype != torch.int32 or xi.dtype != torch.int32 or not (xr.is_contiguous() and xi.is_contiguous()):
        raise TypeError("fft_energy takes contiguous int32 rows")
    n = xr.shape[0]
    out = torch.empty((n, 257), dtype=torch.int32, device=xr.device)
    if n == 0:
        return out
    tb = fe.tables(xr.device, torch.int32)
    lib = _build.load("frontend")
    with torch.cuda.device(xr.device):
        err = lib.kws_fft_energy(
            xr.data_ptr(), xi.data_ptr(), n,
            tb["tw_r"].data_ptr(), tb["tw_i"].data_ptr(), tb["stw_r"].data_ptr(), tb["stw_i"].data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(xr.device).cuda_stream,
        )
    _build.check(lib, err, "fft_energy")
    _build.count(fft_energy)
    return out


_build.counted(fft_energy)
