"""ctypes bindings of the native C++ micro frontend (``src/microfrontend.cc``).

Counterpart of ``multilingual_kws_tpu/native/host_frontend.py``: the host
side's multithreaded batch and stream featurization, for corpus tooling and
CPU pipelines, bit-exact to ``ops/micro_exact.py`` (which the golden tests
pin to the real op). Every float-derived table comes from the port's
``ops/micro_exact.py`` and is passed in, so the C++ is integer only. The
library is built with ``g++`` at first use (``native/__init__.py``).
"""

from __future__ import annotations

import ctypes
import os
import weakref
from typing import Optional

import numpy as np

from ..ops.micro_exact import _LOG_LUT, FrontendConfig, MicroFrontend
from . import load

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I16P = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

SIGNATURES = {
    # window_size, window_step, fft_size, spectrum_size, channels,
    # smoothing_bits, even, odd, min_signal_remaining, enable_pcan,
    # snr_shift, correction_bits, scale_shift, enable_log, window, band
    # starts, band widths, weights, unweights, pcan lut, its size, log lut,
    # its size
    "mf_create": ([_I] * 5 + [_I, _L, _L, _L] + [_I] * 5 + [_I64P] * 5 + [_I64P, _I, _I64P, _I], _P),
    "mf_destroy": ([_P], None),
    # handle, audio (B, N), B, N, out (B, F, C), threads
    "mf_compute_batch": ([_P, _I16P, _I, _I, _F32P, _I], None),
    "mf_num_frames": ([_P, _I], _I),
    # handle, audio (N,), N, windows, frames a window, out, threads
    "mf_compute_stream": ([_P, _I16P, _L, _I, _I, _F32P, _I], None),
}


def default_threads() -> int:
    return max(1, os.cpu_count() or 1)


class NativeMicroFrontend:
    """Multithreaded native frontend; its output is ``MicroFrontendTorch``'s
    ``features_from_int16`` (the reference's 10/256 scale) bit for bit."""

    def __init__(self, config: FrontendConfig = FrontendConfig(), num_threads: Optional[int] = None):
        self.config = config
        self.num_threads = num_threads or default_threads()
        lib = load("microfrontend", SIGNATURES)
        host = MicroFrontend(config)  # the tables (numpy, validated)
        self._host = host
        fb = host.fb
        pcan_lut = host.pcan_lut.astype(np.int64) if config.enable_pcan else np.zeros(1, np.int64)
        log_lut = _LOG_LUT.astype(np.int64)
        self._handle = lib.mf_create(
            host.window_size, host.window_step, host.fft_size, host.spectrum_size, config.num_channels,
            config.smoothing_bits, host.even_smoothing, host.odd_smoothing, host.min_signal_remaining,
            int(config.enable_pcan), host.snr_shift, host.correction_bits, config.scale_shift,
            int(config.enable_log),
            host.window_coeffs.astype(np.int64), fb.band_starts.astype(np.int64), fb.band_widths.astype(np.int64),
            np.concatenate(fb.weights).astype(np.int64), np.concatenate(fb.unweights).astype(np.int64),
            pcan_lut, len(pcan_lut), log_lut, len(log_lut),
        )
        self._lib = lib
        weakref.finalize(self, lib.mf_destroy, self._handle)

    def num_frames(self, num_samples: int) -> int:
        return self._lib.mf_num_frames(self._handle, num_samples)

    def features_from_int16(self, audio: np.ndarray) -> np.ndarray:
        """(B, N) or (N,) int16 -> (B, F, C) / (F, C) float32 (10/256 scale)."""
        squeeze = audio.ndim == 1
        a = np.ascontiguousarray(audio[None] if squeeze else audio, dtype=np.int16)
        b, n = a.shape
        out = np.zeros((b, self.num_frames(n), self.config.num_channels), np.float32)
        self._lib.mf_compute_batch(self._handle, a, b, n, out, self.num_threads)
        return out[0] if squeeze else out

    def features(self, audio_float: np.ndarray) -> np.ndarray:
        """Float waveform in [-1, 1] -> features (the reference's
        ``to_micro_spectrogram`` int16 cast)."""
        i16 = np.clip(np.trunc(np.asarray(audio_float) * 32768.0), -32768, 32767).astype(np.int16)
        return self.features_from_int16(i16)

    def stream_features(self, audio_int16: np.ndarray, num_windows: int, clip_samples: int = 16000) -> np.ndarray:
        """Long (N,) int16 stream -> (num_windows, F_clip, C) float32, one
        window a frame stride; the stateless per-hop prefix is shared across
        windows."""
        host = self._host
        clip_frames = 1 + (clip_samples - host.window_size) // host.window_step
        a = np.ascontiguousarray(audio_int16, dtype=np.int16)
        need = (num_windows - 1 + clip_frames - 1) * host.window_step + host.window_size
        if a.shape[0] < need:
            raise ValueError(f"{num_windows} windows need {need} samples, the stream has {a.shape[0]}")
        out = np.zeros((num_windows, clip_frames, self.config.num_channels), np.float32)
        self._lib.mf_compute_stream(self._handle, a, a.shape[0], num_windows, clip_frames, out, self.num_threads)
        return out
