"""Synthetic keyword corpora and tiny models for the examples.

The port's copy of the corpus generators of the JAX package's test helpers
(``tests/helpers.py``: ``keyword_clip``, ``tone_clip``, ``make_corpus``),
which write wavs through the JAX package; the same seeds give the same
clips. Each synthetic "keyword" is a sequence of tone segments (fake
phonemes): the micro frontend's noise reduction and PCAN suppress
stationary signals, so keywords must be non-stationary, like speech, to
stay separable.

The tiny models are the helpers' narrow EfficientNets (width 0.25, depth
0.4, the first three B0 stages), built with the port's ``make_*_model`` and
Flax's default initialization, so that the examples run in seconds on a
CPU.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..models.efficientnet import BlockArgs
from ..utils.wav import write_wav

SR = 16000

KEYWORD_SEGMENTS = {
    "alpha": [(350.0, 0.18), (700.0, 0.18), (450.0, 0.18)],
    "bravo": [(1600.0, 0.14), (900.0, 0.22), (1900.0, 0.16)],
    "charlie": [(2800.0, 0.12), (2200.0, 0.12), (3300.0, 0.14), (2500.0, 0.14)],
}

TINY_WIDTH, TINY_DEPTH = 0.25, 0.4
TINY_BLOCKS = (BlockArgs(3, 1, 32, 16, 1, 1), BlockArgs(3, 1, 16, 24, 6, 2), BlockArgs(5, 1, 24, 40, 6, 2))


def keyword_clip(word: str, seed: int, noise: float = 0.003) -> np.ndarray:
    """A 1 s clip of the synthetic keyword with per-"speaker" variation:
    +-4 % segment pitch, +-15 % durations, random onset, an amplitude
    envelope per segment."""
    rng = np.random.default_rng(seed)
    pieces = []
    for freq, dur in KEYWORD_SEGMENTS[word]:
        f = freq * (1 + rng.uniform(-0.04, 0.04))
        d = dur * (1 + rng.uniform(-0.15, 0.15))
        n = int(d * SR)
        t = np.arange(n) / SR
        env = np.sin(np.pi * np.minimum(t / max(d, 1e-3), 1.0)) ** 0.5  # fade in/out
        amp = 0.35 * (1 + rng.uniform(-0.2, 0.2))
        pieces.append(amp * env * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)))
    sig = np.concatenate(pieces)
    if sig.shape[0] > SR:
        sig = sig[:SR]
    onset = rng.integers(0, max(SR - sig.shape[0], 1))
    x = np.zeros(SR, np.float32)
    x[onset : onset + sig.shape[0]] = sig
    x = x + rng.normal(0, noise, SR)
    return np.clip(x, -1, 1).astype(np.float32)


def tone_clip(freq: float, seed: int, am: float = 3.0, noise: float = 0.02) -> np.ndarray:
    """A steady amplitude-modulated tone (not separable after the frontend's
    stationary-signal suppression; for frontend-level use)."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR) / SR
    phase = rng.uniform(0, 2 * np.pi)
    f = freq * (1 + rng.uniform(-0.03, 0.03))
    x = 0.4 * np.sin(2 * np.pi * f * t + phase) * (1 + 0.5 * np.sin(2 * np.pi * am * t))
    x = x + rng.normal(0, noise, SR)
    return np.clip(x, -1, 1).astype(np.float32)


def make_corpus(root: Path, clips_per_word: int = 12):
    """Writes root/<word>/<word>_<i>.wav, root/_background_noise_/*.wav and
    root/unknown/ with unknown_files.txt. Returns {word: [paths]} with
    "bg_dir", "unknown_dir" and "unknown_files"."""
    root = Path(root)
    rng = np.random.default_rng(99)
    out = {}
    for w in KEYWORD_SEGMENTS:
        files = []
        for i in range(clips_per_word):
            p = root / w / f"{w}_{i}.wav"
            # zlib.crc32: the same in every process (hash() of a str is not)
            write_wav(p, keyword_clip(w, seed=zlib.crc32(f"{w}_{i}".encode())))
            files.append(str(p))
        out[w] = files

    bg_dir = root / "_background_noise_"
    for i in range(2):
        write_wav(bg_dir / f"noise_{i}.wav", rng.normal(0, 0.05, 3 * SR).astype(np.float32).clip(-1, 1))
    out["bg_dir"] = str(bg_dir)

    unk_dir = root / "unknown"
    unk_files = []
    for i in range(8):  # broadband chirps
        p = unk_dir / f"unk_{i}.wav"
        t = np.arange(SR) / SR
        x = 0.3 * np.sin(2 * np.pi * (500 + 300 * i + 1500 * t) * t)
        write_wav(p, np.clip(x + rng.normal(0, 0.02, SR), -1, 1))
        unk_files.append(f"unk_{i}.wav")
    # the other keywords as unknowns too: the reference's unknowns are words,
    # and with chirps alone every tone sequence would score as the target
    for j, w in enumerate(["bravo", "charlie"]):
        for i in range(4):
            write_wav(unk_dir / f"unk_{w}_{i}.wav", keyword_clip(w, seed=7000 + 100 * j + i))
            unk_files.append(f"unk_{w}_{i}.wav")
    (unk_dir / "unknown_files.txt").write_text("\n".join(unk_files) + "\n")
    out["unknown_dir"] = str(unk_dir)
    out["unknown_files"] = [str(unk_dir / f) for f in unk_files]
    return out


def tiny_transfer_model(device="cuda"):
    """A narrow EfficientNet transfer model (3 outputs) on ``device``."""
    from ..models.kws_model import lecun_init_, make_transfer_model

    model = make_transfer_model(3, device="cpu", width_coefficient=TINY_WIDTH, depth_coefficient=TINY_DEPTH,
                                blocks=TINY_BLOCKS)
    return lecun_init_(model, seed=0).to(resolve_device(device))


def tiny_embedding_model(num_labels: int, device="cuda"):
    """A narrow EfficientNet embedding model (``num_labels`` logits) on
    ``device``."""
    from ..models.kws_model import lecun_init_, make_embedding_model

    model = make_embedding_model(num_labels, device="cpu", width_coefficient=TINY_WIDTH,
                                 depth_coefficient=TINY_DEPTH, blocks=TINY_BLOCKS)
    return lecun_init_(model, seed=0).to(resolve_device(device))
