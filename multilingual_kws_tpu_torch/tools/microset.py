"""MSWC microset construction — the tutorial's small download artifact.

Equivalent of reference notebooks/generate_microset.py:20-50: pick a word
list from an MSWC splits CSV (SET,LINK,WORD,VALID,SPEAKER,GENDER), cap clips
per keyword, optionally filter Mozilla single-word-target-segment clips
(recorded words, not sentence extractions), and emit a per-split manifest +
optionally decode the audio into <word>/<clip>.wav trees.

The port's own copy of ``multilingual_kws_tpu/tools/microset.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set


def generate_microset(
    words: Sequence[str],
    splits_csv,
    swts_stems_to_filter: Optional[Set[str]] = None,
    max_clips_per_kw: int = 6000,
) -> Dict[str, Dict[str, List[str]]]:
    """{split: {word: [clip links]}} for the chosen words (reference :20-55)."""
    words = set(words)
    swts = swts_stems_to_filter or set()
    all_samples: Dict[str, Dict[str, List[str]]] = dict(train={}, dev={}, test={})
    with open(splits_csv) as fh:
        reader = csv.reader(fh)
        next(reader)  # SET,LINK,WORD,VALID,SPEAKER,GENDER
        for row in reader:
            split, clip, word = row[0].lower(), row[1], row[2]
            if word not in words or split not in all_samples:
                continue
            if Path(clip).stem in swts:
                continue
            bucket = all_samples[split].setdefault(word, [])
            if len(bucket) < max_clips_per_kw:
                bucket.append(clip)
    return all_samples


def read_swts_filter(path) -> Set[str]:
    """Clip stems from a Mozilla SWTS mp3 listing (reference :36-39)."""
    with open(path) as fh:
        return {Path(p).stem for p in fh.read().split()}


def write_microset_csv(samples: Dict[str, Dict[str, List[str]]], dest) -> None:
    """Write the microset back out in the MSWC splits-CSV contract."""
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    with open(dest, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["SET", "LINK", "WORD", "VALID", "SPEAKER", "GENDER"])
        for split in ("train", "dev", "test"):
            for word, clips in sorted(samples.get(split, {}).items()):
                for clip in clips:
                    w.writerow([split.upper(), clip, word, "", "", ""])


def materialize_microset(
    samples: Dict[str, Dict[str, List[str]]],
    audio_root,
    dest_root,
    sample_rate: int = 16000,
) -> List[Path]:
    """Decode the selected clips into dest/<split>/<word>/<stem>.wav (opus
    decode needs opus-tools/ffmpeg; wavs convert natively)."""
    from ..utils.audio_ops import decode_to_wav

    audio_root, dest_root = Path(audio_root), Path(dest_root)
    out = []
    for split, words in samples.items():
        for word, clips in words.items():
            for clip in clips:
                src = audio_root / clip
                dst = dest_root / split / word / (Path(clip).stem + ".wav")
                out.append(decode_to_wav(src, dst, sample_rate))
    return out
