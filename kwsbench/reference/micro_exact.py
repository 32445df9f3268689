"""Bit-exact TFLite "micro" audio frontend in numpy: the benchmark's plain
reference of the exact frontend.

A frozen copy of the port's ``ops/micro_exact.py`` (itself validated
bit-exactly against golden outputs of the real TFLite op), kept here so that
no change to the program can move the yardstick. One change: the noise
reduction and PCAN stage runs over any leading batch dimensions, so that
``stream_window_features`` can run the per-window stage of every window of
a long stream at once.

int16 PCM -> framing (30 ms window / 20 ms hop) -> quantized Hann window ->
fixed-point kiss FFT -> 40-channel mel filterbank -> noise reduction -> PCAN
-> integer log.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# --- fixed-point constants (microfrontend lib) ---
WINDOW_BITS = 12  # kFrontendWindowBits
FILTERBANK_BITS = 12  # kFilterbankBits
NOISE_REDUCTION_BITS = 14  # kNoiseReductionBits
PCAN_SNR_BITS = 12  # kPcanSnrBits
PCAN_OUTPUT_BITS = 6  # kPcanOutputBits
WIDE_DYNAMIC_FUNCTION_BITS = 32
LOG_SCALE_LOG2 = 16  # kLogScaleLog2
LOG_SCALE = 1 << LOG_SCALE_LOG2
LOG_SCALE_SHIFT = 16  # kLogScaleShift
LOG_SEGMENTS_LOG2 = 7  # kLogSegmentsLog2
LOG_COEFF = 45426  # kLogCoeff = round(65536 * ln 2)

_U32 = np.uint64(0xFFFFFFFF)


@dataclass(frozen=True)
class FrontendConfig:
    """Mirrors the TF op's python-wrapper defaults (audio_microfrontend)."""

    sample_rate: int = 16000
    window_size_ms: int = 30
    window_step_ms: int = 20
    num_channels: int = 40
    upper_band_limit: float = 7500.0
    lower_band_limit: float = 125.0
    smoothing_bits: int = 10
    even_smoothing: float = 0.025
    odd_smoothing: float = 0.06
    min_signal_remaining: float = 0.05
    enable_pcan: bool = True
    pcan_strength: float = 0.95
    pcan_offset: float = 80.0
    gain_bits: int = 21
    enable_log: bool = True
    scale_shift: int = 6
    out_scale: int = 1


def most_significant_bit32(x):
    """Bit length of a uint32 (0 for 0) — vectorized."""
    x = np.asarray(x, dtype=np.uint64)
    out = np.zeros(x.shape, dtype=np.int64)
    val = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        # standard binary search bitlength (values < 2^64)
        mask = val >= (np.uint64(1) << np.uint64(shift))
        out = np.where(mask, out + shift, out)
        val = np.where(mask, val >> np.uint64(shift), val)
    # now val in {0,1}
    out = out + (val != 0)
    return out


def _sround(x: np.ndarray) -> np.ndarray:
    """kiss_fft sround: (x + 2^14) >> 15, arithmetic shift (x int64)."""
    return (x + (1 << 14)) >> 15


def _fixdiv(r: np.ndarray, i: np.ndarray, div: int) -> Tuple[np.ndarray, np.ndarray]:
    """kiss_fft C_FIXDIV: multiply by SAMP_MAX/div and sround."""
    k = 32767 // div
    return _sround(r * k), _sround(i * k)


def _cmul(ar, ai, br, bi):
    """kiss_fft C_MUL with sround on each component."""
    return _sround(ar * br - ai * bi), _sround(ar * bi + ai * br)


class _KissFftr512:
    """Fixed-point (int16) real FFT of size 512, bit-exact to kiss_fftr.

    512-sample real input -> 257 complex int16 bins. The complex substate is a
    256-point FFT factorized as four radix-4 stages (kiss kf_factor order).
    Vectorized over an arbitrary batch of frames.
    """

    NFFT = 512
    NCFFT = 256  # complex substate size

    def __init__(self):
        n = self.NCFFT
        idx = np.arange(n)
        phase = -2.0 * np.pi * idx / n
        self.tw_r = np.floor(0.5 + 32767 * np.cos(phase)).astype(np.int64)
        self.tw_i = np.floor(0.5 + 32767 * np.sin(phase)).astype(np.int64)
        k = np.arange(n // 2)
        sphase = -np.pi * ((k + 1.0) / n + 0.5)
        self.stw_r = np.floor(0.5 + 32767 * np.cos(sphase)).astype(np.int64)
        self.stw_i = np.floor(0.5 + 32767 * np.sin(sphase)).astype(np.int64)
        # input permutation for the DIT recursion: kf_work with factors
        # (4,64),(4,16),(4,4),(4,1) reduces to a base-4 digit reversal
        self.perm = self._build_perm()

    def _build_perm(self) -> np.ndarray:
        # kf_work gathers input with stride pattern equivalent to reversing
        # the base-4 digits of the output index (4 digits for 256)
        out = np.zeros(self.NCFFT, dtype=np.int64)
        for i in range(self.NCFFT):
            v = i
            r = 0
            for _ in range(4):
                r = (r << 2) | (v & 3)
                v >>= 2
            out[i] = r
        return out

    def _bfly4(self, fr, fi, fstride, m):
        """One radix-4 stage over the last axis, kiss fixed-point semantics.

        fr/fi: (..., G, 4*m) int64 where each group of 4*m is one butterfly
        span; operates in place semantics (returns new arrays).
        """
        k = np.arange(m)
        tw1r = self.tw_r[k * fstride]
        tw1i = self.tw_i[k * fstride]
        tw2r = self.tw_r[2 * k * fstride]
        tw2i = self.tw_i[2 * k * fstride]
        tw3r = self.tw_r[3 * k * fstride]
        tw3i = self.tw_i[3 * k * fstride]

        x0r, x0i = _fixdiv(fr[..., 0 * m:1 * m], fi[..., 0 * m:1 * m], 4)
        x1r, x1i = _fixdiv(fr[..., 1 * m:2 * m], fi[..., 1 * m:2 * m], 4)
        x2r, x2i = _fixdiv(fr[..., 2 * m:3 * m], fi[..., 2 * m:3 * m], 4)
        x3r, x3i = _fixdiv(fr[..., 3 * m:4 * m], fi[..., 3 * m:4 * m], 4)

        s0r, s0i = _cmul(x1r, x1i, tw1r, tw1i)
        s1r, s1i = _cmul(x2r, x2i, tw2r, tw2i)
        s2r, s2i = _cmul(x3r, x3i, tw3r, tw3i)

        s5r = x0r - s1r
        s5i = x0i - s1i
        x0r = x0r + s1r
        x0i = x0i + s1i
        s3r = s0r + s2r
        s3i = s0i + s2i
        s4r = s0r - s2r
        s4i = s0i - s2i

        o2r = x0r - s3r
        o2i = x0i - s3i
        o0r = x0r + s3r
        o0i = x0i + s3i
        # forward transform
        o1r = s5r + s4i
        o1i = s5i - s4r
        o3r = s5r - s4i
        o3i = s5i + s4r

        return (
            np.concatenate([o0r, o1r, o2r, o3r], axis=-1),
            np.concatenate([o0i, o1i, o2i, o3i], axis=-1),
        )

    def _cfft256(self, xr: np.ndarray, xi: np.ndarray):
        """256-point complex FFT, kiss fixed-point, batched over axis 0."""
        b = xr.shape[0]
        fr = xr[:, self.perm]
        fi = xi[:, self.perm]
        # stages bottom-up: (fstride for twiddles, m)
        # recursion: top level fstride=1 m=64; next fstride=4 m=16;
        # fstride=16 m=4; deepest fstride=64 m=1
        for fstride, m in ((64, 1), (16, 4), (4, 16), (1, 64)):
            groups = self.NCFFT // (4 * m)
            fr = fr.reshape(b, groups, 4 * m)
            fi = fi.reshape(b, groups, 4 * m)
            fr, fi = self._bfly4(fr, fi, fstride, m)
            fr = fr.reshape(b, self.NCFFT)
            fi = fi.reshape(b, self.NCFFT)
        return fr, fi

    def __call__(self, frames_int16: np.ndarray):
        """frames_int16: (B, 512) int16 -> (out_r, out_i): (B, 257) int64."""
        x = frames_int16.astype(np.int64)
        b = x.shape[0]
        xr = x[:, 0::2]
        xi = x[:, 1::2]
        br, bi = self._cfft256(xr, xi)

        out_r = np.zeros((b, self.NCFFT + 1), dtype=np.int64)
        out_i = np.zeros((b, self.NCFFT + 1), dtype=np.int64)

        tdc_r, tdc_i = _fixdiv(br[:, 0], bi[:, 0], 2)
        out_r[:, 0] = tdc_r + tdc_i
        out_r[:, self.NCFFT] = tdc_r - tdc_i

        k = np.arange(1, self.NCFFT // 2 + 1)
        fpk_r, fpk_i = _fixdiv(br[:, k], bi[:, k], 2)
        fpnk_r, fpnk_i = _fixdiv(br[:, self.NCFFT - k], -bi[:, self.NCFFT - k], 2)

        f1k_r = fpk_r + fpnk_r
        f1k_i = fpk_i + fpnk_i
        f2k_r = fpk_r - fpnk_r
        f2k_i = fpk_i - fpnk_i
        tw_r, tw_i = _cmul(f2k_r, f2k_i, self.stw_r[k - 1], self.stw_i[k - 1])

        out_r[:, k] = (f1k_r + tw_r) >> 1
        out_i[:, k] = (f1k_i + tw_i) >> 1
        out_r[:, self.NCFFT - k] = (f1k_r - tw_r) >> 1
        out_i[:, self.NCFFT - k] = (tw_i - f1k_i) >> 1
        return out_r, out_i


def _freq_to_mel(freq):
    """FreqToMel in filterbank_util.c: float32 return of a double computation."""
    val = 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)
    return np.asarray(val).astype(np.float32)


@dataclass
class _FilterbankTables:
    start_index: int
    end_index: int
    band_starts: np.ndarray  # (num_channels+1,) first fft bin of each band
    band_widths: np.ndarray  # (num_channels+1,)
    weights: List[np.ndarray]  # per band, quantized 12-bit
    unweights: List[np.ndarray]


def _build_filterbank(cfg: FrontendConfig, spectrum_size: int) -> _FilterbankTables:
    """Mirror of filterbank_util.c channel/weight construction."""
    num_bands = cfg.num_channels + 1
    # all filterbank table math mirrors the C float32 arithmetic exactly
    mel_low = np.float32(_freq_to_mel(np.float32(cfg.lower_band_limit)))
    mel_hi = np.float32(_freq_to_mel(np.float32(cfg.upper_band_limit)))
    mel_span = np.float32(mel_hi - mel_low)
    mel_spacing = np.float32(mel_span / np.float32(num_bands))
    center_mels = (
        mel_low + (mel_spacing * np.arange(1, num_bands + 1, dtype=np.float32))
    ).astype(np.float32)

    hz_per_sbin = np.float32(0.5 * cfg.sample_rate / np.float64(np.float32(spectrum_size) - 1))
    start_index = int(1.5 + cfg.lower_band_limit / hz_per_sbin)

    band_starts = np.zeros(num_bands, dtype=np.int64)
    band_widths = np.zeros(num_bands, dtype=np.int64)
    freq_index = start_index
    for chan in range(num_bands):
        band_starts[chan] = freq_index
        while (
            freq_index < spectrum_size
            and _freq_to_mel(np.float32(np.float32(freq_index) * hz_per_sbin))
            <= center_mels[chan]
        ):
            freq_index += 1
        band_widths[chan] = freq_index - band_starts[chan]
    end_index = freq_index

    weights = []
    unweights = []
    for chan in range(num_bands):
        f0 = band_starts[chan]
        w = band_widths[chan]
        bins = np.arange(f0, f0 + w, dtype=np.float32)
        mel = _freq_to_mel((bins * hz_per_sbin).astype(np.float32))
        denom = np.float32(
            center_mels[chan] - (mel_low if chan == 0 else center_mels[chan - 1])
        )
        if w > 0:
            wt = ((center_mels[chan] - mel).astype(np.float32) / denom).astype(
                np.float32
            )
        else:
            wt = np.zeros(0, dtype=np.float32)
        # QuantizeFilterbankWeights: float32 multiply, double +0.5, floor
        qw = np.floor(
            (wt * np.float32(1 << FILTERBANK_BITS)).astype(np.float32).astype(np.float64)
            + 0.5
        ).astype(np.int64)
        qu = np.floor(
            ((np.float32(1.0) - wt).astype(np.float32) * np.float32(1 << FILTERBANK_BITS))
            .astype(np.float32)
            .astype(np.float64)
            + 0.5
        ).astype(np.int64)
        weights.append(qw)
        unweights.append(qu)

    return _FilterbankTables(
        start_index=start_index,
        end_index=end_index,
        band_starts=band_starts,
        band_widths=band_widths,
        weights=weights,
        unweights=unweights,
    )


def _build_pcan_lut(cfg: FrontendConfig, input_correction_bits: int) -> np.ndarray:
    """Mirror of pcan_gain_control_util.c LUT construction.

    Returns int64 array indexed as in the C code (offset by +6 applied here:
    lut[x] for x<=2; lut[4*i-6 .. 4*i-3] for interval i in [2,32]).
    """
    input_bits = cfg.smoothing_bits - input_correction_bits

    def lookup(x: int) -> int:
        x_f = np.float32(x) / np.float32(np.uint64(1) << np.uint64(input_bits))
        gain = np.float32(
            np.float32(np.uint64(1) << np.uint64(cfg.gain_bits))
            * np.float32(
                np.power(
                    np.float32(x_f + np.float32(cfg.pcan_offset)),
                    np.float32(-cfg.pcan_strength),
                )
            )
        )
        if gain > 32767:
            return 32767
        return int(np.int16(gain + np.float32(0.5)))

    size = 4 * WIDE_DYNAMIC_FUNCTION_BITS - 3
    lut = np.zeros(size + 4, dtype=np.int64)
    lut[0] = lookup(0)
    lut[1] = lookup(1)
    for interval in range(2, WIDE_DYNAMIC_FUNCTION_BITS + 1):
        x0 = 1 << (interval - 1)
        x1 = x0 + (x0 >> 1)
        x2 = (x0 * 2 - 1) if interval == WIDE_DYNAMIC_FUNCTION_BITS else x0 * 2
        y0 = lookup(x0)
        y1 = lookup(x1)
        y2 = lookup(x2)
        diff1 = y1 - y0
        diff2 = y2 - y0
        a1 = 4 * diff1 - diff2
        a2 = diff2 - a1
        base = 4 * interval - 6
        lut[base] = y0
        lut[base + 1] = np.int64(np.int16(a1))  # int16 wrap as in C
        lut[base + 2] = np.int64(np.int16(a2))
        lut[base + 3] = 0
    return lut


def _wide_dynamic_function(x: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Vectorized WideDynamicFunction (x uint32 values as int64)."""
    x = np.asarray(x, dtype=np.int64)
    interval = most_significant_bit32(x)
    base = 4 * interval - 6
    base = np.clip(base, 0, len(lut) - 3)
    l0 = lut[base]
    l1 = lut[base + 1]
    l2 = lut[base + 2]
    frac = np.where(
        interval < 11,
        x << np.maximum(11 - interval, 0),
        x >> np.maximum(interval - 11, 0),
    ) & 0x3FF
    result = (l2 * frac) >> 5
    # C: result += (int32_t)((uint32_t)lut[1] << 5) — plain shift of the
    # (sign-extended) value, truncated to 32 bits
    result = result + np.int64(np.int32((np.int64(l1) << 5) & 0xFFFFFFFF))
    result = result * frac
    result = (result + (1 << 14)) >> 15
    result = result + l0
    small = x <= 2
    return np.where(small, lut[np.clip(x, 0, 2)], result)


def _pcan_shrink(x: np.ndarray) -> np.ndarray:
    big = x >= (2 << PCAN_SNR_BITS)
    small_val = (x * x) >> (2 + 2 * PCAN_SNR_BITS - PCAN_OUTPUT_BITS)
    big_val = (x >> (PCAN_SNR_BITS - PCAN_OUTPUT_BITS)) - (1 << PCAN_OUTPUT_BITS)
    return np.where(big, big_val, small_val)


def _build_log_lut() -> np.ndarray:
    """kLogLut: correction for piecewise-linear log2 fraction."""
    n = 1 << LOG_SEGMENTS_LOG2
    s = np.arange(n + 2, dtype=np.float64)
    vals = np.round(LOG_SCALE * (np.log2(1.0 + s / n) - s / n))
    vals[n:] = 0.0
    return vals.astype(np.int64)


_LOG_LUT = _build_log_lut()


def _log2_fraction_part(x: np.ndarray, log2x: np.ndarray) -> np.ndarray:
    frac = x - (np.int64(1) << np.maximum(log2x, 0))
    frac = np.where(
        log2x < LOG_SCALE_LOG2,
        frac << np.maximum(LOG_SCALE_LOG2 - log2x, 0),
        frac >> np.maximum(log2x - LOG_SCALE_LOG2, 0),
    )
    base_seg = frac >> (LOG_SCALE_LOG2 - LOG_SEGMENTS_LOG2)
    seg_unit = (1 << LOG_SCALE_LOG2) >> LOG_SEGMENTS_LOG2
    c0 = _LOG_LUT[base_seg]
    c1 = _LOG_LUT[base_seg + 1]
    seg_base = seg_unit * base_seg
    rel_pos = ((c1 - c0) * (frac - seg_base)) >> LOG_SCALE_LOG2
    return frac + c0 + rel_pos


def _integer_log(x: np.ndarray, scale_shift: int) -> np.ndarray:
    """Log() from log_scale.c — natural log scaled by 2^scale_shift.

    x must be > 0 where used; callers mask zeros.
    """
    integer = most_significant_bit32(x) - 1
    fraction = _log2_fraction_part(x, integer)
    log2 = (integer << LOG_SCALE_LOG2) + fraction
    rnd = LOG_SCALE // 2
    loge = (LOG_COEFF * log2 + rnd) >> LOG_SCALE_SHIFT
    return ((loge << scale_shift) + rnd) >> LOG_SCALE_SHIFT


def _isqrt_rounded(num: np.ndarray) -> np.ndarray:
    """Sqrt64 semantics: floor sqrt with +1 round-up when remainder > result.

    The C Sqrt64 dispatches to Sqrt32 (round-up cap 0xFFFF) when the value
    fits 32 bits, else uses the 64-bit loop (cap 0xFFFFFFFF).
    """
    num_f = num.astype(np.float64)
    res = np.floor(np.sqrt(num_f)).astype(np.uint64)
    # fix potential float rounding at boundaries
    res = np.where(res * res > num, res - np.uint64(1), res)
    res = np.where((res + np.uint64(1)) * (res + np.uint64(1)) <= num, res + np.uint64(1), res)
    rem = num - res * res
    res_i = res.astype(np.int64)
    cap = np.where(num >> np.uint64(32) == 0, 0xFFFF, 0xFFFFFFFF)
    bump = (rem.astype(np.int64) > res_i) & (res_i != cap)
    return res_i + bump


class MicroFrontend:
    """Bit-exact micro frontend over one audio clip (stateful across frames).

    Usage: ``MicroFrontend(config)(audio_int16)`` -> (num_frames, num_channels)
    uint16 features (if enable_log) scaled by 1/out_scale when converted.
    """

    def __init__(self, config: FrontendConfig = FrontendConfig()):
        self.cfg = config
        c = config
        self.window_size = c.window_size_ms * c.sample_rate // 1000
        self.window_step = c.window_step_ms * c.sample_rate // 1000
        self.fft_size = 1 if self.window_size == 0 else 2 ** (
            (self.window_size - 1).bit_length()
        )
        assert self.fft_size == 512, "fixed-point FFT currently sized for 512"
        self.spectrum_size = self.fft_size // 2 + 1

        # quantized Hann window (window_util.c — arg computed in float32)
        arg = np.float64(np.float32(np.pi * 2.0 / float(self.window_size)))
        i = np.arange(self.window_size, dtype=np.float64)
        fv = np.asarray(
            np.float32(0.5) - np.float32(0.5) * np.cos(arg * (i + 0.5)),
            dtype=np.float64,
        )
        self.window_coeffs = np.floor(fv * (1 << WINDOW_BITS) + 0.5).astype(np.int64)

        self.fft = _KissFftr512()
        self.fb = _build_filterbank(c, self.spectrum_size)

        # correction bits shared by PCAN input scaling and log scaling
        self.correction_bits = (
            int(most_significant_bit32(np.int64(self.fft_size))) - 1 - FILTERBANK_BITS // 2
        )

        # noise reduction quantized params (float32 then truncation, as in C)
        nb = 1 << NOISE_REDUCTION_BITS
        self.even_smoothing = int(np.float32(c.even_smoothing) * nb)
        self.odd_smoothing = int(np.float32(c.odd_smoothing) * nb)
        self.min_signal_remaining = int(np.float32(c.min_signal_remaining) * nb)

        if c.enable_pcan:
            self.pcan_lut = _build_pcan_lut(c, self.correction_bits)
            self.snr_shift = c.gain_bits - self.correction_bits - PCAN_SNR_BITS
        else:
            self.pcan_lut = None
            self.snr_shift = 0

    # -- stages --------------------------------------------------------------

    def frame_and_window(self, audio: np.ndarray):
        """(samples,) int16 -> windowed frames (F, win) int16-range int64 + max_abs."""
        n = audio.shape[0]
        if n < self.window_size:
            return np.zeros((0, self.window_size), np.int64), np.zeros(0, np.int64)
        num_frames = 1 + (n - self.window_size) // self.window_step
        idx = (
            np.arange(num_frames)[:, None] * self.window_step
            + np.arange(self.window_size)[None, :]
        )
        frames = audio.astype(np.int64)[idx]
        windowed = (frames * self.window_coeffs[None, :]) >> WINDOW_BITS
        # int16 wrap semantics for the stored output and its abs
        w16 = windowed.astype(np.int16).astype(np.int64)
        neg = np.where(w16 < 0, (-w16).astype(np.int16).astype(np.int64), w16)
        max_abs = neg.max(axis=1)
        return w16, max_abs

    def fft_energy(self, windowed: np.ndarray, max_abs: np.ndarray):
        """Windowed frames -> (F, spectrum) uint32 energies + per-frame shift."""
        shift = 15 - most_significant_bit32(np.maximum(max_abs, 0))
        shift = np.clip(shift, 0, 15)
        scaled = (
            (windowed.astype(np.uint16) << shift[:, None].astype(np.uint16))
            .astype(np.int16)
            .astype(np.int64)
        )
        fft_in = np.zeros((windowed.shape[0], self.fft_size), dtype=np.int16)
        fft_in[:, : self.window_size] = scaled.astype(np.int16)
        fr, fi = self.fft(fft_in)
        energy = fr * fr + fi * fi  # fits in int64; C stores as uint32 (no wrap)
        return energy, shift

    def filterbank(self, energy: np.ndarray, shift: np.ndarray) -> np.ndarray:
        """Energies -> (F, num_channels) uint32 'scaled_filterbank' values."""
        fb = self.fb
        nb = self.cfg.num_channels + 1
        f = energy.shape[0]
        wacc = np.zeros((f, nb), dtype=np.int64)  # weighted sums per band
        uacc = np.zeros((f, nb), dtype=np.int64)
        for band in range(nb):
            s = fb.band_starts[band]
            w = fb.band_widths[band]
            if w == 0:
                continue
            e = energy[:, s : s + w]
            wacc[:, band] = (e * fb.weights[band][None, :]).sum(axis=1)
            uacc[:, band] = (e * fb.unweights[band][None, :]).sum(axis=1)
        # work[i] = wacc[0] if i==0 else uacc[i-1] + wacc[i]; output drops work[0]
        work = uacc[:, :-1] + wacc[:, 1:]
        res = _isqrt_rounded(work.astype(np.uint64))
        return res >> shift[:, None]

    def noise_reduction_and_pcan(self, signal: np.ndarray) -> np.ndarray:
        """Sequential (per-frame) noise reduction + PCAN over (..., F, C) signals."""
        c = self.cfg
        f, nch = signal.shape[-2:]
        estimate = np.zeros(signal.shape[:-2] + (nch,), dtype=np.int64)
        smoothing = np.where(
            np.arange(nch) % 2 == 0, self.even_smoothing, self.odd_smoothing
        ).astype(np.int64)
        one_minus = (1 << NOISE_REDUCTION_BITS) - smoothing
        out = np.zeros_like(signal)
        for t in range(f):
            sig = signal[..., t, :]
            scaled_up = (sig << c.smoothing_bits) & 0xFFFFFFFF
            estimate = (
                (scaled_up * smoothing + estimate * one_minus)
                >> NOISE_REDUCTION_BITS
            ) & 0xFFFFFFFF
            # subtraction happens in the scaled-up domain, then shifts down
            # (== signal - ceil(estimate / 2^smoothing_bits) when positive)
            subtracted = np.maximum(scaled_up - estimate, 0) >> c.smoothing_bits
            floor_ = (sig * self.min_signal_remaining) >> NOISE_REDUCTION_BITS
            nr = np.maximum(subtracted, floor_)
            if c.enable_pcan:
                gain = _wide_dynamic_function(estimate, self.pcan_lut)
                snr = (nr * gain) >> self.snr_shift
                out[..., t, :] = _pcan_shrink(snr)
            else:
                out[..., t, :] = nr
        return out

    def log_scale(self, signal: np.ndarray) -> np.ndarray:
        c = self.cfg
        if not c.enable_log:
            # output path stores into uint16 with saturation
            return np.minimum(signal, 0xFFFF)
        value = signal << self.correction_bits
        logged = np.where(value > 0, _integer_log(np.maximum(value, 1), c.scale_shift), 0)
        return np.minimum(logged, 0xFFFF)

    # -- full pipeline ---------------------------------------------------------

    def __call__(self, audio_int16: np.ndarray) -> np.ndarray:
        """(samples,) int16 -> (frames, channels) int64 feature values."""
        windowed, max_abs = self.frame_and_window(np.asarray(audio_int16))
        if windowed.shape[0] == 0:
            return np.zeros((0, self.cfg.num_channels), dtype=np.int64)
        energy, shift = self.fft_energy(windowed, max_abs)
        fbank = self.filterbank(energy, shift)
        nrp = self.noise_reduction_and_pcan(fbank)
        return self.log_scale(nrp)
