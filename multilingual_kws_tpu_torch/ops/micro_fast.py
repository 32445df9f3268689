"""The micro frontend's fast mode: a float prefix and an integer-valued
float32 suffix.

Counterpart of ``mode="fast"`` of ``multilingual_kws_tpu/ops/micro_jax.py``
(``_base_frames_fast`` and ``nr_pcan_log``). Fast mode trades the exact
fixed-point prefix for a float rFFT; its features land within a few grid
steps of exact mode's and are held to the JAX package's fast mode, never to
exact mode.

- The prefix (``base_frames_fast``): framing, window coefficients / 4096,
  a 512-point ``torch.fft.rfft`` (cuFFT on the card; the JAX package also
  leaves it to its FFT library), energies scaled by 1/512^2, the float
  filterbank product (TF32 off) and ``sqrt``.
- The suffix: the noise-estimate recurrence (``ops/cuda_fast.noise_scan_f32``,
  a CUDA kernel on the card), then the pointwise stages below.

The pointwise stages reproduce what XLA computes for the JAX package's
expressions, not the mathematically exact values:

- XLA contracts ``a * b + c`` into one fused multiply-add where the product
  is not exact in float32 (``r * frac + 16384`` of the gain and
  ``LOG_COEFF * log2v + 32768`` of the log): ``_fma`` rounds once, through
  float64, where a float32 product would round twice;
- ``jnp.log2(x)`` is ``log(x) / log(2)``, which XLA turns into
  ``log(x) * float32(1 / log(2))``; its floor is one low at some powers of
  two (2^13, 2^15, 2^26, 2^27, 2^30, 2^31): ``log2_jax`` computes the same
  product;
- ``jnp.exp2(x)`` is ``exp(x * float32(log 2))``, which is not a power of
  two for integer x >= 13 (exp2(13) = 8192.004): ``exp2_jax`` computes the
  same;
- ``log`` and ``exp`` are taken in float64 and rounded to float32, so that
  the CPU and the card give the same value (XLA's agree with them wherever
  the results above depend on them);
- the one-hot matrix products that look up the gain and log tables hold one
  nonzero term, so an index lookup gives the same values (0 for an index
  outside the table, as ``jax.nn.one_hot`` gives).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch

from .micro_exact import (
    LOG_COEFF,
    LOG_SCALE_LOG2,
    LOG_SEGMENTS_LOG2,
    NOISE_REDUCTION_BITS,
    PCAN_OUTPUT_BITS,
    PCAN_SNR_BITS,
    WINDOW_BITS,
    _LOG_LUT,
)
from .micro_int import wdf_tables

LN2_F32 = float(np.float32(math.log(2.0)))
INV_LN2_F32 = float(np.float32(1.0 / math.log(2.0)))


def filterbank_matrix(fb, num_channels: int, bins: int) -> np.ndarray:
    """(bins, C) float32 filterbank: channel c sums the unweights of band c
    and the weights of band c+1 (the JAX package's ``_build_tables``)."""
    mat = np.zeros((bins, num_channels), dtype=np.float64)
    for c in range(num_channels):
        s0, w0 = fb.band_starts[c], fb.band_widths[c]
        mat[s0 : s0 + w0, c] += fb.unweights[c]
        s1, w1 = fb.band_starts[c + 1], fb.band_widths[c + 1]
        mat[s1 : s1 + w1, c] += fb.weights[c + 1]
    return mat.astype(np.float32)


def fast_host_tables(host, config) -> Dict[str, np.ndarray]:
    """The fast mode's float32 tables from a ``micro_exact.MicroFrontend``."""
    ch = np.arange(config.num_channels)
    sm = np.where(ch % 2 == 0, host.even_smoothing, host.odd_smoothing).astype(np.float32)
    lut = _LOG_LUT.astype(np.float32)
    n_seg = 1 << LOG_SEGMENTS_LOG2
    tables = {
        "window": host.window_coeffs.astype(np.float32) / np.float32(1 << WINDOW_BITS),
        "fb": filterbank_matrix(host.fb, config.num_channels, host.spectrum_size),
        "sm": sm,
        "om": np.float32(1 << NOISE_REDUCTION_BITS) - sm,
        "log_pairs": np.stack([lut[: n_seg + 1], lut[1 : n_seg + 2]], axis=1),
    }
    if config.enable_pcan:
        rows, lut012 = wdf_tables(host.pcan_lut)
        tables["wdf_rows"], tables["lut012"] = rows.astype(np.float32), lut012.astype(np.float32)
    return tables


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (the fused multiply-add XLA emits):
    the float32 product is exact in float64."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def log2_jax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` as XLA computes it: log(x) * float32(1 / log 2)."""
    return torch.log(x.to(torch.float64)).to(torch.float32) * INV_LN2_F32


def exp2_jax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` as XLA computes it: exp(x * float32(log 2))."""
    return torch.exp((x * LN2_F32).to(torch.float64)).to(torch.float32)


def _lookup(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``jax.nn.one_hot(index, n) @ table`` for integer-valued float index:
    table rows, and zeros where the index is outside [0, n)."""
    i = index.to(torch.int64)
    n = table.shape[0]
    rows = table[i.clamp(0, n - 1)]
    return torch.where(((i >= 0) & (i < n))[..., None], rows, torch.zeros_like(rows))


def windows_view(base: torch.Tensor, num_windows: int, stride: int, frames: int) -> torch.Tensor:
    """(R, C) rows -> (num_windows, frames, C) view: window w is rows
    w*stride .. w*stride+frames-1 (no copy)."""
    if num_windows == 0 or frames == 0:
        return base.new_zeros((num_windows, frames, base.shape[1]))
    return base.unfold(0, frames, stride)[:num_windows].transpose(1, 2)


def base_frames_fast(audio: torch.Tensor, fe) -> torch.Tensor:
    """(..., samples) integer audio -> (..., F, C) float32 sqrt-filterbank
    signal (``_base_frames_fast``). No per-frame input shift: the exact
    mode's shift cancels in real arithmetic."""
    tb = fe.fast_tables(audio.device)
    win, step = fe.window_size, fe.window_step
    lead, t = audio.shape[:-1], audio.shape[-1]
    if t < win:
        return torch.zeros((*lead, 0, fe.num_channels), dtype=torch.float32, device=audio.device)
    frames = audio.to(torch.float32).unfold(-1, win, step)  # (..., F, win)
    spec = torch.fft.rfft(frames * tb["window"], n=512, dim=-1)
    energy = (spec.real.square() + spec.imag.square()) * (1.0 / 512.0**2)
    with _float32_products(energy.is_cuda):
        fbank = torch.matmul(energy, tb["fb"])
    return torch.sqrt(fbank.clamp(min=0.0))


@contextlib.contextmanager
def _float32_products(cuda: bool):
    """Matrix products in full float32 inside the block, whatever the caller
    allowed: no TF32 on the card; on the CPU no oneDNN, which runs float32
    products in bf16 under ``torch.set_float32_matmul_precision("medium")``
    on CPUs with bf16 units (the default CPU product is not oneDNN's)."""
    if cuda:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        prev = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = prev
        else:
            torch.backends.mkldnn.enabled = prev


def wide_dynamic_function_fast(x: torch.Tensor, tb) -> torch.Tensor:
    """WideDynamicFunction on integer-valued float32 (the JAX package's
    fast-mode emulation, with its float semantics)."""
    xs = x.clamp(min=1.0)
    interval = torch.floor(log2_jax(xs)) + 1.0
    frac = torch.floor(xs * exp2_jax(11.0 - interval)) - 1024.0
    row = _lookup(tb["wdf_rows"], interval - 1.0)
    l0, l1, l2 = row.unbind(-1)
    r = torch.floor(l2 * frac / 32.0)
    r = r + l1 * 32.0
    r = torch.floor(_fma(r, frac, 16384.0) / 32768.0)
    r = r + l0
    lut012 = tb["lut012"]
    small = torch.where(x < 1.0, lut012[0], torch.where(x < 2.0, lut012[1], lut012[2]))
    return torch.where(x <= 2.0, small, r)


def pcan_fast(nr: torch.Tensor, gain: torch.Tensor, snr_shift: int) -> torch.Tensor:
    """PCAN gain and shrink on integer-valued float32."""
    snr = torch.floor(nr * gain / float(1 << snr_shift))
    small = torch.floor(snr * snr / float(1 << (2 + 2 * PCAN_SNR_BITS - PCAN_OUTPUT_BITS)))
    big = torch.floor(snr / float(1 << (PCAN_SNR_BITS - PCAN_OUTPUT_BITS))) - float(1 << PCAN_OUTPUT_BITS)
    return torch.where(snr >= float(2 << PCAN_SNR_BITS), big, small)


def log_fast(x: torch.Tensor, correction_bits: int, scale_shift: int, tb) -> torch.Tensor:
    """log_scale.c's Log() on integer-valued float32, capped at 65535."""
    v = x * float(1 << correction_bits)
    vs = v.clamp(min=1.0)
    integer = torch.floor(log2_jax(vs))
    frac0 = vs - exp2_jax(integer)
    frac = torch.where(
        integer < LOG_SCALE_LOG2,
        frac0 * exp2_jax(LOG_SCALE_LOG2 - integer),
        torch.floor(frac0 / exp2_jax(integer - LOG_SCALE_LOG2)),
    )
    seg_unit = float(1 << (LOG_SCALE_LOG2 - LOG_SEGMENTS_LOG2))
    base_seg = torch.floor(frac / seg_unit)
    c0, c1 = _lookup(tb["log_pairs"], base_seg).unbind(-1)
    rel = torch.floor((c1 - c0) * (frac - seg_unit * base_seg) / 65536.0)
    log2v = integer * 65536.0 + (frac + c0 + rel)
    loge = torch.floor(_fma(log2v, float(LOG_COEFF), 32768.0) / 65536.0)
    logged = torch.floor((loge * float(1 << scale_shift) + 32768.0) / 65536.0)
    return torch.where(v > 0, logged, torch.zeros_like(logged)).clamp(max=65535.0)


def nr_pcan_log_fast(x: torch.Tensor, est: torch.Tensor, fe) -> torch.Tensor:
    """The pointwise stages after the recurrence: signal and estimate of
    one shape -> integer-valued float32 features (before the 10/256 scale)."""
    tb = fe.fast_tables(x.device)
    sb = float(1 << fe.smoothing_bits)
    nrb = float(1 << NOISE_REDUCTION_BITS)
    subtracted = torch.floor((x * sb - est).clamp(min=0.0) / sb)
    floor_ = torch.floor(x * float(fe.min_signal_remaining) / nrb)
    out = torch.maximum(subtracted, floor_)
    if fe.enable_pcan:
        out = pcan_fast(out, wide_dynamic_function_fast(est, tb), fe.snr_shift)
    if fe.enable_log:
        out = log_fast(out, fe.correction_bits, fe.scale_shift, tb)
    else:
        out = out.clamp(max=65535.0)
    return torch.round(out) if fe.quantize else out
