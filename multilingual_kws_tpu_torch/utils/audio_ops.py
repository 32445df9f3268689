"""Host-side audio DSP: resample / trim / fade / pad / concat.

Replaces the reference's `sox` subprocess pipeline for clip extraction
(word_extraction.py:193-231: convert 48k->16k, trim, 25 ms fades, pad;
generate_stream_sentences.py:210-214: sox.Combiner concatenation) with pure
numpy/scipy — no external binaries in the data-construction path. mp3/opus
decode (corpus prep only) is delegated to ffmpeg/opusdec WHEN present,
matching the reference's optional tooling (SURVEY.md section 2.4).

The port's own copy of ``multilingual_kws_tpu/utils/audio_ops.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

from .wav import read_wav, write_wav


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (sox `convert(samplerate=...)` equivalent)."""
    if sr_in == sr_out:
        return np.asarray(audio, np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    out = resample_poly(np.asarray(audio, np.float64), sr_out // g, sr_in // g)
    return np.clip(out, -1.0, 1.0).astype(np.float32)


def trim(audio: np.ndarray, sr: int, start_s: float, end_s: float) -> np.ndarray:
    """sox Transformer.trim equivalent."""
    a = max(0, int(round(start_s * sr)))
    b = min(audio.shape[0], int(round(end_s * sr)))
    return np.asarray(audio[a:b], np.float32)


def fade(
    audio: np.ndarray, sr: int, fade_in_s: float = 0.025, fade_out_s: float = 0.025
) -> np.ndarray:
    """sox Transformer.fade equivalent (quarter-sine ramps, sox default)."""
    out = np.asarray(audio, np.float32).copy()
    n_in = min(int(round(fade_in_s * sr)), out.shape[0])
    n_out = min(int(round(fade_out_s * sr)), out.shape[0])
    if n_in > 0:
        ramp = np.sin(0.5 * np.pi * np.arange(n_in) / n_in)
        out[:n_in] *= ramp
    if n_out > 0:
        ramp = np.sin(0.5 * np.pi * (np.arange(n_out) + 1) / n_out)
        out[-n_out:] *= ramp[::-1]
    return out


def pad(audio: np.ndarray, sr: int, start_s: float = 0.0, end_s: float = 0.0):
    """sox Transformer.pad equivalent (silence before/after)."""
    return np.concatenate(
        [
            np.zeros(int(round(start_s * sr)), np.float32),
            np.asarray(audio, np.float32),
            np.zeros(int(round(end_s * sr)), np.float32),
        ]
    )


def concat(clips: Sequence[np.ndarray]) -> np.ndarray:
    """sox.Combiner("concatenate") equivalent."""
    return (
        np.concatenate([np.asarray(c, np.float32) for c in clips])
        if clips
        else np.zeros(0, np.float32)
    )


def duration_s(path) -> float:
    """soxi -D equivalent via native WAV header parse."""
    from .wav import wav_info

    info = wav_info(path)
    return info.num_samples / info.sample_rate


def decode_to_wav(src, dest, sample_rate: int = 16000) -> Path:
    """mp3/opus/other -> wav via external decoder when available.

    Corpus-prep only (reference used ffmpeg/opusdec, tutorial cell 7 /
    dataperf_validation_filter.py:24-31). Raises RuntimeError when no
    decoder binary is present; wav inputs are resampled natively.
    """
    src, dest = Path(src), Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    if src.suffix.lower() == ".wav":
        audio, sr = read_wav(src)
        write_wav(dest, resample(audio, sr, sample_rate), sample_rate)
        return dest
    if src.suffix.lower() == ".opus" and shutil.which("opusdec"):
        subprocess.run(
            ["opusdec", "--rate", str(sample_rate), str(src), str(dest)],
            check=True, capture_output=True,
        )
        return dest
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-i", str(src), "-ar", str(sample_rate), "-ac", "1",
             str(dest)],
            check=True, capture_output=True,
        )
        return dest
    raise RuntimeError(
        f"no decoder available for {src.suffix} (install ffmpeg/opus-tools "
        "for mp3/opus corpus prep)"
    )


def read_audio_any(path, sample_rate: int = 16000) -> np.ndarray:
    """Read any supported audio file as float32 mono at sample_rate."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        audio, sr = read_wav(path)
        return resample(audio, sr, sample_rate)
    with tempfile.TemporaryDirectory() as td:
        wav = decode_to_wav(path, Path(td) / "tmp.wav", sample_rate)
        audio, _ = read_wav(wav)
        return audio
