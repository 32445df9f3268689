"""Waveform augmentation and int16 quantization of a training batch, as one
CUDA kernel and its plain PyTorch version.

Replaces ``multilingual_kws_tpu/ops/pallas_augment.py::augment_kernel_call``
(the Pallas kernel ``_augment_quantize_kernel``) with the resident-bank
gather before it (``data/dataset._resident_gather``) and the background
window gather (``pallas_augment.gather_bg_window``): the kernel reads each
clip's foreground row from an int16 bank by row index (a batch uploaded from
the host is its own bank, with the identity rows) and its background crop
from the padded float32 background bank directly. The kernel is
``augment_quantize`` in ``csrc/augment.cu``.

``draw_augment_params(gen, ...)`` draws the per-clip parameters with the
distributions of ``pallas_augment.draw_augment_params``, from an explicit
``torch.Generator`` on the data's device. ``augment_quantize(...)`` applies
them: on CUDA tensors it launches the kernel (or raises), on CPU tensors it
runs ``augment_quantize_plain``.

On the card the kernel is bound by bytes: 128 KB per 1 s clip (int16 in,
float32 background, int16 out) against 17 float operations per sample. Its
first design, one block per clip in two passes (the RMS sums, then the mix,
reading every sample again), reached 0.91 of that bound at 2048 clips. At
batches too small to fill the card (the fine-tune's 64 clips) the kernel
now spreads each clip over a thread block cluster of two to eight blocks
and reads device memory once: each thread keeps its samples in registers,
each block reduces its two partial sums, the blocks exchange them through
distributed shared memory and add them in rank order, then mix and
quantize from registers. Larger batches keep one block per clip and two
passes, the faster way once the batch fills the card. The source note in
``csrc/augment.cu`` has the rest. Kernel and plain version differ only in
the order of the RMS sums: samples of mixed rows may differ by one int16
step, rarely; silence rows and rows with volume 0 are ``==``. The kernel's
sum order is fixed (no atomics), so two launches on the same inputs give
the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .augment import AugmentParams, augment_waveforms


class AugmentDraws(NamedTuple):
    """Per-clip parameters (B,) on the data's device: shifts (int32, in
    [-max_shift, max_shift)), background idx and off (int32), sil_vol and
    volume (float32; volume is 0 where the clip is not mixed)."""

    shifts: torch.Tensor
    idx: torch.Tensor
    off: torch.Tensor
    sil_vol: torch.Tensor
    volume: torch.Tensor


def draw_augment_params(
    gen: torch.Generator, b: int, t: int, bg_sizes: torch.Tensor, params: AugmentParams
) -> AugmentDraws:
    """The draws of ``pallas_augment.draw_augment_params``, in its
    distributions: shift ~ U{-max_shift..max_shift-1}; background clip ~
    U{0..n_bg-1}, offset ~ U{0..2^30} mod max(size - t, 1); silence volume ~
    U[0,1); mixed with probability background_frequency at a volume ~ U[0,
    background_volume_range)."""
    dev = gen.device
    max_shift = int(params.time_shift_samples)
    if max_shift > 0:
        shifts = torch.randint(-max_shift, max_shift, (b,), generator=gen, device=dev)
    else:
        shifts = torch.zeros((b,), dtype=torch.int64, device=dev)
    idx = torch.randint(0, bg_sizes.shape[0], (b,), generator=gen, device=dev)
    max_off = torch.clamp(bg_sizes.to(dev)[idx] - t, min=1)
    off = torch.randint(0, 2**30, (b,), generator=gen, device=dev) % max_off
    sil_vol = torch.rand((b,), generator=gen, device=dev)
    do_mix = torch.rand((b,), generator=gen, device=dev) < params.background_frequency
    mix_vol = torch.rand((b,), generator=gen, device=dev) * params.background_volume_range
    volume = torch.where(do_mix, mix_vol, 0.0)
    i32 = torch.int32
    return AugmentDraws(shifts.to(i32), idx.to(i32), off.to(i32), sil_vol, volume)


def augment_quantize_plain(fg_bank, rows, is_silence, bg_bank, draws: AugmentDraws) -> torch.Tensor:
    """Plain version: gather, ``ops/augment.augment_waveforms``, then the
    saturating float -> int16 quantize of ``micro_jax._features_impl``.
    Raises IndexError on a row, background clip or offset outside its bank
    (where the kernel stops with a device error)."""
    for name, v, hi in (
        ("rows", rows, fg_bank.shape[0] - 1),
        ("idx", draws.idx, bg_bank.shape[0] - 1),
        ("off", draws.off, bg_bank.shape[1]),
    ):
        if v.numel() and (int(v.min()) < 0 or int(v.max()) > hi):
            raise IndexError(f"augment_quantize: {name} outside [0, {hi}]")
    fg = fg_bank[rows.to(torch.int64)].to(torch.float32) * np.float32(1.0 / 32768.0)
    wav = augment_waveforms(fg, is_silence, bg_bank, *draws)
    return torch.clamp(torch.trunc(wav * 32768.0), -32768.0, 32767.0).to(torch.int16)


def augment_quantize(
    fg_bank: torch.Tensor,
    rows: torch.Tensor,
    is_silence: torch.Tensor,
    bg_bank: torch.Tensor,
    draws: AugmentDraws,
) -> torch.Tensor:
    """fg_bank (N, T) int16, rows (B,) int32 into it, is_silence (B,) bool,
    bg_bank (n_bg, W) float32 padded background bank, draws (B,) ->
    (B, T) int16 augmented audio. Kernel on CUDA tensors, plain version on
    CPU tensors."""
    if fg_bank.dim() != 2 or bg_bank.dim() != 2:
        raise ValueError("augment_quantize takes (rows, samples) foreground and background banks")
    b = rows.shape[0]
    for name, v in (("rows", rows), ("is_silence", is_silence), *draws._asdict().items()):
        if tuple(v.shape) != (b,):
            raise ValueError(f"augment_quantize: {name} has shape {tuple(v.shape)}, expected ({b},)")
    tensors = (fg_bank, rows, is_silence, bg_bank, *draws)
    if all(v.device.type == "cpu" for v in tensors):
        return augment_quantize_plain(fg_bank, rows, is_silence, bg_bank, draws)
    if any(v.device != fg_bank.device for v in tensors) or fg_bank.device.type != "cuda":
        raise ValueError("augment_quantize takes its tensors on one CUDA device (or all on the CPU)")
    want = {
        "fg_bank": (fg_bank, torch.int16), "rows": (rows, torch.int32),
        "is_silence": (is_silence, torch.bool), "bg_bank": (bg_bank, torch.float32),
        "shifts": (draws.shifts, torch.int32), "idx": (draws.idx, torch.int32),
        "off": (draws.off, torch.int32), "sil_vol": (draws.sil_vol, torch.float32),
        "volume": (draws.volume, torch.float32),
    }
    for name, (v, dtype) in want.items():
        if v.dtype != dtype or not v.is_contiguous():
            raise TypeError(f"augment_quantize: {name} must be contiguous {dtype}, got {v.dtype}")
    t = fg_bank.shape[1]
    out = torch.empty((b, t), dtype=torch.int16, device=fg_bank.device)
    if out.numel() == 0:
        return out
    lib = _build.load("augment")
    with torch.cuda.device(fg_bank.device):
        err = lib.kws_augment_quantize(
            fg_bank.data_ptr(), fg_bank.shape[0], b, t, rows.data_ptr(), draws.shifts.data_ptr(),
            is_silence.data_ptr(), bg_bank.data_ptr(), bg_bank.shape[0], bg_bank.shape[1],
            draws.idx.data_ptr(), draws.off.data_ptr(), draws.sil_vol.data_ptr(),
            draws.volume.data_ptr(), float(np.float32(1.0 / t)), out.data_ptr(),
            torch.cuda.current_stream(fg_bank.device).cuda_stream,
        )
    _build.check(lib, err, "augment_quantize")
    _build.count(augment_quantize)
    return out


_build.counted(augment_quantize)
