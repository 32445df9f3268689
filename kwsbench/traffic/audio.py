"""Seeded audio: tone-sequence clips and a long stream of keywords and
distractors over a varying noise floor, and a 16-bit wav writer.

``tone_clip`` and ``stream`` are frozen copies of ``chip_smoke.py``'s
``tone_clip`` and ``synth_stream`` (the stream every earlier measurement of
the port's streaming path used); ``words_corpus`` of its
``pretrain_corpus``, with the clip count a parameter."""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

SR = 16000
KEYWORD_FREQS = (350, 700, 450)


def to_int16(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> int16 as the reference's decode and cast round
    trips it (truncation, saturation)."""
    return np.clip(np.trunc(np.asarray(x, np.float64) * 32768.0), -32768, 32767).astype(np.int16)


def write_wav(path, samples_int16: np.ndarray, sr: int = SR) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(samples_int16, "<i2").tobytes())


def tone_clip(rng: np.random.Generator, freqs) -> np.ndarray:
    """A 1 s clip: a noise floor and a tone sequence (sqrt-sine envelopes)
    at a random onset, as float32."""
    x = rng.normal(0, 0.004, SR) * rng.uniform(0.3, 3.0)
    segs = []
    for f in freqs:
        tt = np.arange(int(rng.uniform(0.12, 0.22) * SR)) / SR
        env = np.sqrt(np.clip(np.sin(np.pi * tt / tt[-1]), 0, 1))
        segs.append(rng.uniform(0.2, 0.5) * env * np.sin(2 * np.pi * f * rng.uniform(0.96, 1.04) * tt))
    sig = np.concatenate(segs)[:SR]
    onset = int(rng.integers(0, SR - sig.shape[0] + 1))
    x[onset : onset + sig.shape[0]] += sig
    return np.clip(x, -1, 1).astype(np.float32)


def stream(seconds: int, seed: int, keyword: str = "alpha") -> Tuple[np.ndarray, List[Tuple[str, int]]]:
    """A stream of ``seconds`` seconds: a noise floor whose level changes
    every second, the keyword's tone sequence and distractor sequences at
    gaps of 1.5-3.5 s. Returns (int16 samples, [(keyword, onset ms)])."""
    rng = np.random.default_rng(seed)
    n = seconds * SR
    x = rng.normal(0, 0.004, n) * np.repeat(rng.uniform(0.3, 3.0, seconds), SR)
    labels = []
    t = 1.0
    while t < seconds - 2.0:
        kind = keyword if rng.random() < 0.5 else "other"
        freqs = KEYWORD_FREQS if kind == keyword else tuple(rng.uniform(900, 3300, 3))
        pos = int(t * SR)
        for f in freqs:
            m = int(rng.uniform(0.12, 0.22) * SR)
            tt = np.arange(m) / SR
            env = np.sqrt(np.clip(np.sin(np.pi * tt / tt[-1]), 0, 1))
            x[pos : pos + m] += rng.uniform(0.2, 0.5) * env * np.sin(2 * np.pi * f * tt)
            pos += m
        if kind == keyword:
            labels.append((keyword, int(t * 1000)))
        t += rng.uniform(1.5, 3.5)
    return to_int16(np.clip(x, -1, 1).astype(np.float32)), labels


def background(rng: np.random.Generator, count: int = 3, seconds: int = 8) -> List[np.ndarray]:
    """Background noise wavs (int16): white noise whose level changes every second."""
    return [to_int16(np.clip(rng.normal(0, 0.05, seconds * SR) * np.repeat(rng.uniform(0.3, 2.0, seconds), SR), -1, 1))
            for _ in range(count)]


def words_corpus(root: Path, seed: int, words: int, clips: int) -> Dict:
    """``words`` words, each a tone sequence of three frequencies of its own,
    ``clips`` clips of each (onset, pitch and loudness vary), the last of
    each to validate, written under ``root/<word>/``; three 8 s background
    wavs under ``root/_background_noise_``. Returns the file lists and the
    int16 clips in file order."""
    rng = np.random.default_rng(seed)
    out = {"words": [], "train": [], "val": [], "audio": {}}
    for w in range(words):
        word = f"w{w:03d}"
        freqs = tuple(rng.uniform(300, 3500, 3))
        out["words"].append(word)
        for i in range(clips):
            path = str(root / word / f"{word}_{i}.wav")
            a = to_int16(tone_clip(rng, freqs))
            write_wav(path, a)
            out["audio"][path] = a
            out["val" if i == clips - 1 else "train"].append(path)
    out["bg_dir"] = str(root / "_background_noise_")
    out["background"] = background(rng)
    for i, a in enumerate(out["background"]):
        write_wav(root / "_background_noise_" / f"noise_{i}.wav", a)
    return out
