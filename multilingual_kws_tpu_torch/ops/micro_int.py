"""Bit-exact integer stages of the micro frontend as plain torch functions.

Counterpart of ``multilingual_kws_tpu/ops/micro_int.py``. The C
microfrontend computes its filterbank, noise-reduction, PCAN and log stages
in uint32 with uint64 intermediates. Here every value is an **int64**
tensor holding the uint32 value, and ``& U32`` is applied wherever C wraps
a uint32. No intermediate reaches 2^63: filterbank sums stay below 2^51,
the noise recurrence below 2^47 (``(sig<<10 mod 2^32) * 2^14 + est * 2^14``).

These functions are the plain versions that the CUDA kernels in
``csrc/frontend.cu`` are held to; they run on CPU or CUDA tensors alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .micro_exact import (
    LOG_COEFF,
    LOG_SCALE_LOG2,
    LOG_SEGMENTS_LOG2,
    NOISE_REDUCTION_BITS,
    PCAN_OUTPUT_BITS,
    PCAN_SNR_BITS,
)

U32 = 0xFFFFFFFF


def msb32(x: torch.Tensor) -> torch.Tensor:
    """Bit length of each uint32 value (0 for 0)."""
    out = torch.zeros_like(x)
    val = x
    for s in (16, 8, 4, 2, 1):
        m = val >= (1 << s)
        out = torch.where(m, out + s, out)
        val = torch.where(m, val >> s, val)
    return out + (val != 0).to(x.dtype)


def filterbank_tables(fb, num_channels: int):
    """Per-channel (bin index, 12-bit weight) pairs, padded to one width.

    Channel c accumulates the unweights of band c plus the weights of band
    c+1 (``micro_exact.MicroFrontend.filterbank``: work = uacc[:-1] +
    wacc[1:]). Padding entries have weight 0. fb is
    ``micro_exact._FilterbankTables``. Returns two (C, W) int64 arrays.
    """
    rows = []
    for c in range(num_channels):
        s0, w0 = int(fb.band_starts[c]), int(fb.band_widths[c])
        s1, w1 = int(fb.band_starts[c + 1]), int(fb.band_widths[c + 1])
        idx = np.concatenate([np.arange(s0, s0 + w0), np.arange(s1, s1 + w1)])
        wgt = np.concatenate([fb.unweights[c], fb.weights[c + 1]])
        rows.append((idx, wgt))
    width = max(len(i) for i, _ in rows)
    idx = np.zeros((num_channels, width), np.int64)
    wgt = np.zeros((num_channels, width), np.int64)
    for c, (ri, rw) in enumerate(rows):
        idx[c, : len(ri)] = ri
        wgt[c, : len(rw)] = rw
    return idx, wgt


def filterbank_accumulate(energy: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor):
    """(..., bins) uint32 energies -> (..., C) exact 64-bit weighted sums.

    energy < 2^32, weight <= 2^12, at most 128 terms: each sum < 2^51."""
    e = energy[..., idx]  # (..., C, W)
    return (e * wgt).sum(dim=-1)


def sqrt64_exact(num: torch.Tensor) -> torch.Tensor:
    """Sqrt64 of ``micro_exact._isqrt_rounded``: floor sqrt, +1 when the
    remainder exceeds the root, except at the cap (0xFFFF when the value
    fits 32 bits, else 0xFFFFFFFF). num < 2^52, so the float64 root is
    within one of the integer root and one correction step each way is
    enough."""
    r = torch.sqrt(num.to(torch.float64)).floor().to(torch.int64)
    r = torch.where(r * r > num, r - 1, r)
    r = torch.where((r + 1) * (r + 1) <= num, r + 1, r)
    rem = num - r * r
    cap = torch.where((num >> 32) == 0, 0xFFFF, 0xFFFFFFFF)
    return r + ((rem > r) & (r != cap)).to(torch.int64)


def nr_estimate_step(est, sig, sm, om, smoothing_bits: int = 10):
    """One frame of the noise-estimate recurrence (noise_reduction.c):
    est' = (uint64(sig << sb) * sm + uint64(est) * om) >> 14, mod 2^32."""
    su = (sig << smoothing_bits) & U32
    return ((su * sm + est * om) >> NOISE_REDUCTION_BITS) & U32


def noise_estimate_scan_u32(x: torch.Tensor, sm, om, smoothing_bits: int = 10):
    """(F, ..., C) int64 signal -> (F, ..., C) estimate sequence, carry from
    0: the recurrence of the Pallas ``noise_estimate_scan_u32``."""
    est = torch.zeros_like(x[0])
    out = torch.empty_like(x)
    for t in range(x.shape[0]):
        est = nr_estimate_step(est, x[t], sm, om, smoothing_bits)
        out[t] = est
    return out


def nr_subtract(sig, est, msr: int, smoothing_bits: int = 10):
    """Scaled-domain subtraction with clamp, then the min-signal floor."""
    su = (sig << smoothing_bits) & U32
    subtracted = (su - torch.minimum(est, su)) >> smoothing_bits
    floor_ = ((sig * msr) >> NOISE_REDUCTION_BITS) & U32
    return torch.maximum(subtracted, floor_)


def wdf_tables(pcan_lut: np.ndarray):
    """(32, 3) per-interval gain LUT rows and the 3 direct entries (x <= 2)
    of WideDynamicFunction, as int64 arrays."""
    lut = np.asarray(pcan_lut, np.int64)
    rows = [
        [lut[b], lut[b + 1], lut[b + 2]]
        for b in (min(max(4 * i - 6, 0), len(lut) - 3) for i in range(1, 33))
    ]
    return np.asarray(rows, np.int64), lut[:3].copy()


def wide_dynamic_function(x, wdf_rows, lut012):
    """Exact WideDynamicFunction (pcan_gain_control.c) of uint32 values.
    wdf_rows: (32, 3) int64 tensor; lut012: (3,) int64 tensor."""
    interval = msb32(x)
    row = wdf_rows[(interval - 1).clamp(0, 31)]  # (..., 3)
    l0, l1, l2 = row[..., 0], row[..., 1], row[..., 2]
    frac = torch.where(
        interval < 11,
        (x << (11 - interval).clamp(min=0)) & U32,
        x >> (interval - 11).clamp(min=0),
    ) & 0x3FF
    r = (l2 * frac) >> 5
    r = r + l1 * 32
    r = (r * frac + (1 << 14)) >> 15
    r = r + l0
    return torch.where(x <= 2, lut012[x.clamp(max=2)], r)


def pcan_gain(nr, gain, snr_shift: int):
    """snr = (uint64(nr) * uint32(gain)) >> snr_shift (mod 2^32), then
    PcanShrink."""
    snr = ((nr * (gain & U32)) >> snr_shift) & U32
    s = snr.clamp(max=2 << PCAN_SNR_BITS)
    small_val = (s * s) >> (2 + 2 * PCAN_SNR_BITS - PCAN_OUTPUT_BITS)
    big_val = ((snr >> (PCAN_SNR_BITS - PCAN_OUTPUT_BITS)) - (1 << PCAN_OUTPUT_BITS)) & U32
    return torch.where(snr >= (2 << PCAN_SNR_BITS), big_val, small_val)


def log_scale_int(x, correction_bits: int, scale_shift: int, log_lut):
    """Exact integer log of log_scale.c on value = x << correction_bits
    (uint32), capped at 0xFFFF; 0 where the value is 0. log_lut: the
    (130,) int64 ``_LOG_LUT`` tensor."""
    value = (x << correction_bits) & U32
    v = value.clamp(min=1)
    integer = msb32(v) - 1
    frac = v - (torch.ones_like(v) << integer)
    frac = torch.where(
        integer < LOG_SCALE_LOG2,
        frac << (LOG_SCALE_LOG2 - integer).clamp(min=0),
        frac >> (integer - LOG_SCALE_LOG2).clamp(min=0),
    )
    seg_shift = LOG_SCALE_LOG2 - LOG_SEGMENTS_LOG2
    base_seg = frac >> seg_shift
    c0 = log_lut[base_seg]
    c1 = log_lut[base_seg + 1]
    rel = ((c1 - c0) * (frac - (base_seg << seg_shift))) >> LOG_SCALE_LOG2
    log2v = (integer << LOG_SCALE_LOG2) + frac + c0 + rel
    rnd = 1 << (LOG_SCALE_LOG2 - 1)
    loge = (LOG_COEFF * log2v + rnd) >> LOG_SCALE_LOG2
    logged = ((((loge << scale_shift) & U32) + rnd) & U32) >> LOG_SCALE_LOG2
    return torch.where(value > 0, logged, 0).clamp(max=0xFFFF)
