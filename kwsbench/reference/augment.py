"""The training batch's augmentation and SpecAugment, plain.

The draws are frozen copies of the port's ``draw_augment_params`` and
``draw_spec_masks`` (the distributions of the TPU package's draws, made
from an explicit ``torch.Generator``): given a generator in the state the
program's generator had, they draw the same numbers. The arithmetic is the
reference's (input_data.py:141-369 of harvard-edge/multilingual_kws) as the
TPU package's augment kernel computes it: time shift with zero fill, a
background crop mixed at ``volume`` times the foreground's RMS over the
crop's, silence rows the crop at ``sil_vol``, clipped to [-1, 1]; then the
saturating float -> int16 cast; SpecAugment zeroes the drawn time and
frequency bands of the features of the rows it applies to.

``host_draw`` is a frozen copy of the data set's first host draw of a
training pass (one ``numpy.random.default_rng(seed)``): the reference's
per-slot substitution of a reshuffled permutation by silence.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

TIME_SHIFT = 1600  # 100 ms at 16 kHz
BACKGROUND_FREQUENCY = 0.8
BACKGROUND_VOLUME = 0.1
SPEC_PERCENTAGE = 80.0
SPEC_N_RANGE = 2
SPEC_MAX_PX = 2


def draw_augment(gen: torch.Generator, b: int, t: int, bg_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
    dev = gen.device
    shifts = torch.randint(-TIME_SHIFT, TIME_SHIFT, (b,), generator=gen, device=dev)
    idx = torch.randint(0, bg_sizes.shape[0], (b,), generator=gen, device=dev)
    max_off = torch.clamp(bg_sizes.to(dev)[idx] - t, min=1)
    off = torch.randint(0, 2**30, (b,), generator=gen, device=dev) % max_off
    sil_vol = torch.rand((b,), generator=gen, device=dev)
    do_mix = torch.rand((b,), generator=gen, device=dev) < BACKGROUND_FREQUENCY
    mix_vol = torch.rand((b,), generator=gen, device=dev) * BACKGROUND_VOLUME
    return {"shifts": shifts, "idx": idx, "off": off, "sil_vol": sil_vol, "volume": torch.where(do_mix, mix_vol, 0.0)}


def draw_spec(gen: torch.Generator, b: int, t: int, f: int) -> Dict[str, torch.Tensor]:
    dev = gen.device

    def axis(axis_len):
        n = torch.randint(0, SPEC_N_RANGE + 1, (b,), generator=gen, device=dev)
        sizes = torch.randint(1, SPEC_MAX_PX + 1, (b, SPEC_N_RANGE), generator=gen, device=dev)
        starts = torch.randint(0, 2**30, (b, SPEC_N_RANGE), generator=gen, device=dev)
        return n, sizes, starts % torch.clamp(axis_len - sizes, min=1)

    apply = torch.rand((b,), generator=gen, device=dev) < (SPEC_PERCENTAGE / 100.0)
    fn, fs, fst = axis(f)
    tn, ts, tst = axis(t)
    return {"apply": apply, "freq": (fn, fs, fst), "time": (tn, ts, tst)}


def augment_int16(fg_int16: np.ndarray, is_silence: np.ndarray, background: Sequence[np.ndarray],
                  d: Dict[str, torch.Tensor]) -> np.ndarray:
    """(B, T) int16 clips -> (B, T) int16 augmented clips (numpy, float32
    arithmetic)."""
    shifts, idx, off = (d[k].cpu().numpy().astype(np.int64) for k in ("shifts", "idx", "off"))
    sil_vol, volume = (d[k].cpu().numpy().astype(np.float32) for k in ("sil_vol", "volume"))
    b, t = fg_int16.shape
    fg = fg_int16.astype(np.float32) * np.float32(1.0 / 32768.0)
    out = np.empty((b, t), np.int16)
    j = np.arange(t)
    for r in range(b):
        src = j - shifts[r]
        x = np.where((src >= 0) & (src < t), fg[r, np.clip(src, 0, t - 1)], np.float32(0.0))
        bgw = background[idx[r]].astype(np.float32) * np.float32(1.0 / 32768.0)
        col = off[r] + j
        bg = np.where(col < bgw.shape[0], bgw[np.clip(col, 0, bgw.shape[0] - 1)], np.float32(0.0))
        inv_t = np.float32(1.0 / t)
        fg_rms = np.sqrt(np.float32(np.sum(x * x, dtype=np.float64)) * inv_t)
        bg_rms = np.sqrt(np.float32(np.sum(bg * bg, dtype=np.float64)) * inv_t)
        scale = np.float32(fg_rms / bg_rms) if bg_rms > 0 else np.float32(0.0)
        mixed = np.clip(x + bg * (scale * volume[r]), -1.0, 1.0)
        wav = bg * sil_vol[r] if is_silence[r] else mixed
        out[r] = np.clip(np.trunc(wav.astype(np.float32) * np.float32(32768.0)), -32768, 32767).astype(np.int16)
    return out


def apply_spec(specs: np.ndarray, m: Dict) -> np.ndarray:
    """(B, T, F) features with the drawn bands zeroed where ``apply``."""
    b, t, f = specs.shape
    apply = m["apply"].cpu().numpy()

    def keep(axis_len, n, sizes, starts):
        n, sizes, starts = (v.cpu().numpy() for v in (n, sizes, starts))
        pos = np.arange(axis_len)[None, None, :]
        active = (np.arange(sizes.shape[1])[None, :] < n[:, None])[..., None]
        inside = (pos >= starts[..., None]) & (pos < (starts + sizes)[..., None])
        return np.where(np.any(active & inside, axis=1), 0.0, 1.0).astype(np.float32)

    fk, tk = keep(f, *m["freq"]), keep(t, *m["time"])
    full = np.where(apply[:, None, None], tk[:, :, None] * fk[:, None, :], np.float32(1.0))
    return specs * full


def host_draw(seed: int, num_files: int, batch: int, label_ids: np.ndarray, silence_id: int,
              silence_percentage: float, unknown_id: int = -1, num_unknown: int = 0,
              unknown_percentage: float = 0.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The first step of a pass over a bank that holds the ``num_files``
    training clips and then the ``num_unknown`` unknown clips: (bank row, 0
    for silence; label; is silence) of each slot. Each slot takes the next
    file of a permutation, reshuffled when it runs out, then becomes silence
    with ``silence_percentage``, else unknown with ``unknown_percentage``
    (a clip drawn from the unknown ones)."""
    rng = np.random.default_rng(seed)
    order, cursor, chunks, need = rng.permutation(num_files), 0, [], batch
    while need:
        if cursor >= num_files:
            order, cursor = rng.permutation(num_files), 0
        m = min(need, num_files - cursor)
        chunks.append(order[cursor : cursor + m])
        cursor, need = cursor + m, need - m
    fidx = np.concatenate(chunks)
    is_sil = rng.uniform(size=batch) < silence_percentage / 100.0
    if num_unknown and unknown_percentage > 0:
        is_unk = ~is_sil & (rng.uniform(size=batch) < unknown_percentage / 100.0)
        unk_pick = rng.integers(num_unknown, size=batch)
    else:
        is_unk, unk_pick = np.zeros(batch, bool), np.zeros(batch, np.int64)
    lbl = label_ids[fidx].copy()
    lbl[is_sil] = silence_id
    lbl[is_unk] = unknown_id
    rows = np.where(is_unk, num_files + unk_pick, fidx)
    return np.where(is_sil, 0, rows), lbl, is_sil
