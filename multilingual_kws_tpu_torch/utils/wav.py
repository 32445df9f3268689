"""WAV read/write with tf.audio.decode_wav-compatible semantics (pure numpy).

The reference decodes via tf.audio.decode_wav(desired_channels=1,
desired_samples=N) (input_data.py:38-47,396-401): 16-bit PCM -> float32 in
[-1, 1) by /32768, truncate or zero-pad to desired_samples, first channel.

Header parsing is done directly (the reference shells out to soxi for
validation, run.py:259-268 — here it's native).

The port's own copy of ``multilingual_kws_tpu/utils/wav.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import struct
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class WavInfo:
    sample_rate: int
    num_channels: int
    num_samples: int
    sample_width_bytes: int

    @property
    def duration_seconds(self) -> float:
        return self.num_samples / self.sample_rate


def wav_info(path) -> WavInfo:
    with wave.open(str(path), "rb") as w:
        return WavInfo(
            sample_rate=w.getframerate(),
            num_channels=w.getnchannels(),
            num_samples=w.getnframes(),
            sample_width_bytes=w.getsampwidth(),
        )


def read_wav(
    path,
    desired_samples: Optional[int] = None,
    desired_channels: int = 1,
) -> Tuple[np.ndarray, int]:
    """Returns (float32 waveform [-1, 1), sample_rate).

    Matches tf.audio.decode_wav: int16 / 32768, zero-pad or truncate to
    desired_samples, take the first desired_channels channel(s) (mono output
    squeezed to 1-D).
    """
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        # 8-bit wav is unsigned
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if nch > 1:
        data = data.reshape(-1, nch)[:, :desired_channels]
        if desired_channels == 1:
            data = data[:, 0]
    if desired_samples is not None:
        n = data.shape[0]
        if n >= desired_samples:
            data = data[:desired_samples]
        else:
            pad = [(0, desired_samples - n)] + [(0, 0)] * (data.ndim - 1)
            data = np.pad(data, pad)
    return np.ascontiguousarray(data, dtype=np.float32), sr


def read_wav_int16(
    path, desired_samples: Optional[int] = None
) -> Tuple[np.ndarray, int]:
    """Returns (int16 waveform, sample_rate) — the PCM samples untouched.

    The device input path ships int16 to the card (half the host->device
    bytes of float32) and casts to float on device; int16/32768.0 in
    float32 is exact, so features are bit-identical to the read_wav path.
    """
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        if width != 2:
            # rare non-16-bit inputs: decode float then quantize with the
            # library's trunc(x*32768) convention — the exact cast the
            # frontend applied when this audio was fed as float, so
            # features stay bit-identical to the read_wav path
            data, sr = read_wav(path, desired_samples=desired_samples)
            return (
                np.clip(np.trunc(data * 32768.0), -32768, 32767).astype(np.int16),
                sr,
            )
        raw = w.readframes(w.getnframes())
    data = np.frombuffer(raw, dtype="<i2")
    if nch > 1:
        data = data.reshape(-1, nch)[:, 0]
    if desired_samples is not None:
        n = data.shape[0]
        if n >= desired_samples:
            data = data[:desired_samples]
        else:
            data = np.pad(data, (0, desired_samples - n))
    return np.ascontiguousarray(data, dtype=np.int16), sr


def write_wav(path, waveform: np.ndarray, sample_rate: int = 16000) -> None:
    """Float [-1, 1] (or int16) mono waveform -> 16-bit PCM wav."""
    waveform = np.asarray(waveform)
    if waveform.dtype != np.int16:
        waveform = np.clip(np.round(waveform * 32767.0), -32768, 32767).astype(
            np.int16
        )
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(waveform.tobytes())


def validate_sample_wav(path, sample_rate: int = 16000, duration_s: float = 1.0):
    """The reference's soxi-based sample validation (run.py:259-268), native.

    Raises ValueError if not a {duration_s}-second {sample_rate} Hz wav.
    """
    info = wav_info(path)
    if info.sample_rate != sample_rate or info.num_samples != int(
        sample_rate * duration_s
    ):
        raise ValueError(
            f"{path} appears to not be a {sample_rate} Hz {duration_s}-second wav "
            f"(got {info.sample_rate} Hz, {info.num_samples} samples)"
        )
