"""Training augmentation: parameters, the float waveform semantics, SpecAugment.

Counterpart of ``multilingual_kws_tpu/ops/augment.py`` (reference semantics:
input_data.py:141-369):

- ``AugmentParams`` / ``SpecAugParams`` and ``pad_background_bank``, copied;
- ``augment_waveforms``: time shift with zero fill, background crop,
  RMS-equalized mix and silence substitution, in float32, given the drawn
  parameters. It follows the arithmetic of the Pallas kernel
  ``pallas_augment._augment_quantize_kernel`` (``rms = sqrt(sum * (1/t))``),
  which the augment kernel's plain version (``ops/cuda_augment.py``) and the
  kernel itself repeat;
- SpecAugment split into ``draw_spec_masks`` (the random draws, from an
  explicit ``torch.Generator``) and ``apply_spec_masks`` (the masking), so
  that tests can apply the JAX package's draws.

torch cannot reproduce ``jax.random``: the draws have the JAX package's
distributions, not its bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class SpecAugParams:
    """Reference SpecAugParams (input_data.py:160-170)."""

    percentage: float = 80.0
    frequency_n_range: int = 2
    frequency_max_px: int = 2
    time_n_range: int = 2
    time_max_px: int = 2


@dataclass(frozen=True)
class AugmentParams:
    time_shift_samples: int = 1600  # 100 ms @ 16 kHz
    background_frequency: float = 0.8
    background_volume_range: float = 0.1
    spec_aug: SpecAugParams = SpecAugParams()


# block of the JAX package's coarse background gather; the padded bank width
# is kept so that both packages crop from identical banks
BG_BLK = 512


def pad_background_bank(bg_data: np.ndarray, num_samples: int = 16000):
    """Right-pad the bank with zeros so that every crop lies inside it: width
    covers floor(max_off/BG_BLK)*BG_BLK plus ceil((num_samples + BG_BLK -
    1)/BG_BLK) whole blocks (as the JAX package pads it)."""
    nblk_win = -(-(num_samples + BG_BLK - 1) // BG_BLK)
    max_len = bg_data.shape[1]
    need = (max(0, max_len - num_samples) // BG_BLK + nblk_win) * BG_BLK
    if need > max_len:
        pad = np.zeros((bg_data.shape[0], need - max_len), bg_data.dtype)
        bg_data = np.concatenate([bg_data, pad], axis=1)
    return bg_data


def augment_waveforms(fg, is_silence, bg_bank, shifts, idx, off, sil_vol, volume):
    """(B, T) float32 foreground in [-1, 1) -> (B, T) float32 augmented audio.

    shifts (B,): out[j] = fg[j - shift], zero where the source falls outside;
    idx, off (B,): the background crop bank[idx, off + j] (zero past the
    bank's width); sil_vol (B,): the silence rows' crop volume; volume (B,):
    the mix volume (0 for rows that are not mixed)."""
    b, t = fg.shape
    dev = fg.device
    j = torch.arange(t, device=dev)[None, :]
    src = j - shifts.to(torch.int64)[:, None]
    fg = torch.where((src >= 0) & (src < t), fg.gather(1, src.clamp(0, t - 1)), 0.0)
    width = bg_bank.shape[1]
    col = off.to(torch.int64)[:, None] + j
    bg = torch.where(
        col < width, bg_bank[idx.to(torch.int64)[:, None], col.clamp(max=width - 1)], 0.0
    )
    inv_t = torch.tensor(np.float32(1.0 / t), device=dev)
    fg_rms = torch.sqrt(torch.sum(fg * fg, dim=-1, keepdim=True) * inv_t)
    bg_rms = torch.sqrt(torch.sum(bg * bg, dim=-1, keepdim=True) * inv_t)
    scaling = torch.where(bg_rms > 0, fg_rms / torch.clamp(bg_rms, min=1e-30), 0.0)
    mixed = torch.clamp(fg + bg * (scaling * volume[:, None]), -1.0, 1.0)
    return torch.where(is_silence[:, None], bg * sil_vol[:, None], mixed)


class SpecMaskDraws(NamedTuple):
    """SpecAugment's draws for a batch: whether each sample is masked, and per
    axis the number of active masks (B,), their sizes and starts (B, n)."""

    apply: torch.Tensor
    freq_n: torch.Tensor
    freq_sizes: torch.Tensor
    freq_starts: torch.Tensor
    time_n: torch.Tensor
    time_sizes: torch.Tensor
    time_starts: torch.Tensor


def draw_spec_masks(gen: torch.Generator, b: int, t: int, f: int, params: SpecAugParams) -> SpecMaskDraws:
    """The draws of the JAX package's ``spec_augment``, in its distributions:
    apply ~ U[0,1) < percentage/100; per axis n ~ U{0..n_range}, sizes ~
    U{1..max_px}, starts ~ U{0..2^30} mod max(axis_len - size, 1)."""
    dev = gen.device

    def axis(axis_len, n_range, max_px):
        n = torch.randint(0, n_range + 1, (b,), generator=gen, device=dev)
        sizes = torch.randint(1, max_px + 1, (b, n_range), generator=gen, device=dev)
        starts = torch.randint(0, 2**30, (b, n_range), generator=gen, device=dev)
        return n, sizes, starts % torch.clamp(axis_len - sizes, min=1)

    apply = torch.rand((b,), generator=gen, device=dev) < (params.percentage / 100.0)
    fn, fs, fst = axis(f, params.frequency_n_range, params.frequency_max_px)
    tn, ts, tst = axis(t, params.time_n_range, params.time_max_px)
    return SpecMaskDraws(apply, fn, fs, fst, tn, ts, tst)


def _axis_keep(axis_len, n, sizes, starts):
    """(B, axis_len) 1.0 where no active mask covers a position, else 0.0."""
    pos = torch.arange(axis_len, device=n.device)[None, None, :]
    active = (torch.arange(sizes.shape[1], device=n.device)[None, :] < n[:, None])[..., None]
    inside = (pos >= starts[..., None]) & (pos < (starts + sizes)[..., None])
    return torch.where(torch.any(active & inside, dim=1), 0.0, 1.0)


def apply_spec_masks(specs: torch.Tensor, d: SpecMaskDraws) -> torch.Tensor:
    """(B, T, F) specs with the drawn time and frequency masks zeroed on the
    samples whose ``apply`` is set (reference input_data.py:306-369)."""
    _, t, f = specs.shape
    fmask = _axis_keep(f, d.freq_n, d.freq_sizes, d.freq_starts)
    tmask = _axis_keep(t, d.time_n, d.time_sizes, d.time_starts)
    full = torch.where(d.apply[:, None, None], tmask[:, :, None] * fmask[:, None, :], 1.0)
    return specs * full


def spec_augment(gen: torch.Generator, specs: torch.Tensor, params: SpecAugParams = SpecAugParams()):
    """Batched SpecAugment of (B, T, F) specs, drawn from ``gen``."""
    b, t, f = specs.shape
    return apply_spec_masks(specs, draw_spec_masks(gen, b, t, f, params))
