"""The exact frontend over clips and over the windows of a long stream,
from ``micro_exact`` (numpy, bit-exact to the TFLite op).

Features are the op's integers scaled by 10/256 in float32, as the
reference's ``to_micro_spectrogram`` returns them."""

from __future__ import annotations

import numpy as np

from .micro_exact import FrontendConfig, MicroFrontend

SCALE = np.float32(10.0 / 256.0)


def frontend() -> MicroFrontend:
    return MicroFrontend(FrontendConfig())


def clip_features(audio_int16: np.ndarray, fe: MicroFrontend = None) -> np.ndarray:
    """(B, N) int16 clips -> (B, frames, 40) float32 features."""
    fe = fe or frontend()
    audio = np.asarray(audio_int16)
    frames = np.stack([fe.frame_and_window(a)[0] for a in audio])
    max_abs = np.stack([fe.frame_and_window(a)[1] for a in audio])
    b, f, w = frames.shape
    energy, shift = fe.fft_energy(frames.reshape(b * f, w), max_abs.reshape(b * f))
    fbank = fe.filterbank(energy, shift).reshape(b, f, -1)
    return fe.log_scale(fe.noise_reduction_and_pcan(fbank)).astype(np.float32) * SCALE


def stream_prefix(audio_int16: np.ndarray, fe: MicroFrontend) -> np.ndarray:
    """The stateless stages over every frame of a stream: (frames, 40)
    filterbank outputs (int64)."""
    windowed, max_abs = fe.frame_and_window(np.asarray(audio_int16))
    energy, shift = fe.fft_energy(windowed, max_abs)
    return fe.filterbank(energy, shift)


def stream_window_features(audio_int16: np.ndarray, num_windows: int, window_frames: int = 49,
                           stride_frames: int = 1, block: int = 2048):
    """Yields (start window, (n, window_frames, 40) float32 features) for
    blocks of the stream's windows: window w holds stream frames
    [w * stride_frames, w * stride_frames + window_frames), each window's
    noise reduction starting afresh, as the op does for each clip."""
    fe = frontend()
    need = (num_windows - 1) * stride_frames + window_frames
    base = stream_prefix(np.asarray(audio_int16)[: (need - 1) * fe.window_step + fe.window_size], fe)
    assert base.shape[0] >= need, (base.shape, need)
    for w0 in range(0, num_windows, block):
        w = np.arange(w0, min(num_windows, w0 + block))
        idx = w[:, None] * stride_frames + np.arange(window_frames)[None, :]
        feats = fe.log_scale(fe.noise_reduction_and_pcan(base[idx]))
        yield w0, feats.astype(np.float32) * SCALE
