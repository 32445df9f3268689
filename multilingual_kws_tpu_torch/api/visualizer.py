"""Visualizer artifacts: peaks.js waveform .dat writer + data-dir assembly.

Replaces the external BBC `audiowaveform` binary (reference run.py:182-183
generates stream.dat with `audiowaveform -i wav -o dat -b 8`) with a native
implementation of the binary .dat format (version 1): per-pixel min/max
peaks of the waveform at a fixed samples-per-pixel zoom.

The port's own copy of ``multilingual_kws_tpu/api/visualizer.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import shutil
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.wav import read_wav


def waveform_peaks(
    samples: np.ndarray, samples_per_pixel: int = 256
) -> np.ndarray:
    """(N,) float [-1,1] -> (P, 2) int min/max peak pairs."""
    n = samples.shape[0]
    pixels = int(np.ceil(n / samples_per_pixel))
    padded = np.zeros(pixels * samples_per_pixel, dtype=np.float32)
    padded[:n] = samples
    frames = padded.reshape(pixels, samples_per_pixel)
    # avoid zero-padding distorting the final frame's min/max
    if n % samples_per_pixel:
        last = samples[(pixels - 1) * samples_per_pixel :]
        mins = frames.min(axis=1)
        maxs = frames.max(axis=1)
        mins[-1] = last.min()
        maxs[-1] = last.max()
    else:
        mins = frames.min(axis=1)
        maxs = frames.max(axis=1)
    return np.stack([mins, maxs], axis=1)


def write_waveform_dat(
    wav_path,
    out_path,
    samples_per_pixel: int = 256,
    bits: int = 8,
) -> None:
    """Write a peaks.js-compatible binary .dat file (audiowaveform v1)."""
    samples, sample_rate = read_wav(wav_path)
    peaks = waveform_peaks(samples, samples_per_pixel)
    length = peaks.shape[0]
    if bits == 8:
        data = np.clip(np.round(peaks * 127.0), -128, 127).astype(np.int8)
        flags = 1
    elif bits == 16:
        data = np.clip(np.round(peaks * 32767.0), -32768, 32767).astype("<i2")
        flags = 0
    else:
        raise ValueError("bits must be 8 or 16")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "wb") as fh:
        fh.write(struct.pack("<iIii", 1, flags, sample_rate, samples_per_pixel))
        fh.write(struct.pack("<I", length))
        fh.write(data.tobytes())


def read_waveform_dat(path):
    """Parse a v1 .dat file back into (header dict, (P,2) array) — used by
    tests and tooling."""
    with open(path, "rb") as fh:
        version, flags, sample_rate, spp = struct.unpack("<iIii", fh.read(16))
        (length,) = struct.unpack("<I", fh.read(4))
        dtype = np.int8 if (flags & 1) else np.dtype("<i2")
        data = np.frombuffer(fh.read(), dtype=dtype)[: length * 2].reshape(length, 2)
    return (
        dict(version=version, bits=8 if flags & 1 else 16,
             sample_rate=sample_rate, samples_per_pixel=spp, length=length),
        data,
    )


def install_site(dest_dir) -> Path:
    """Copy the self-contained visualizer page (api/static/index.html — the
    reference served a peaks.js app, visualizer/index.html) into dest_dir."""
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).parent / "static" / "index.html"
    target = dest_dir / "index.html"
    shutil.copy2(src, target)
    return target


def assemble_visualizer_data(
    data_dest,
    wav,
    detections: dict,
    transcript=None,
    overwrite: bool = False,
) -> list:
    """Populate visualizer/data (stream.wav, stream.dat, detections.json,
    full_transcript.json) — reference run.py:157-195."""
    data_dest = Path(data_dest)
    data_dest.mkdir(parents=True, exist_ok=True)
    viz_dat = data_dest / "stream.dat"
    viz_wav = data_dest / "stream.wav"
    viz_detections = data_dest / "detections.json"
    viz_transcript = data_dest / "full_transcript.json"
    files = [viz_dat, viz_wav, viz_detections]

    if not overwrite:
        for f in files + [viz_transcript]:
            if f.exists():
                raise FileExistsError(f"{f} already exists (pass overwrite)")

    shutil.copy2(wav, viz_wav)
    with open(viz_detections, "w") as fh:
        json.dump(detections, fh)
    write_waveform_dat(wav, viz_dat, bits=8)
    if transcript is not None:
        shutil.copy2(transcript, viz_transcript)
        files.append(viz_transcript)
    return files
