"""Embedding-corpus scaffolding: frequent-word selection + manifest writing.

Equivalents of the reference corpus-construction scripts:
- frequent_words.py:135-160 — top-N frequent words per language (N=50,
  min 5 chars, skip the top-20 stopwords)
- multi_language_embedding_data.py:29-44 — multilingual command selection
  (words with > 2200 extracted clips across languages)
- multi_language_embedding_data.py:96-184 — 10% validation split with a
  train/val overlap assertion, written as commands.txt / train_files.txt /
  val_files.txt (the manifest contract in data/manifests.py)

The port's own copy of ``multilingual_kws_tpu/tools/corpus.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import glob
import os
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.manifests import write_lines


def select_frequent_words(
    counts: Counter,
    n_words: int = 50,
    min_char_len: int = 5,
    skip_first_n: int = 20,
) -> List[str]:
    """Top-N non-stopword frequent words (reference frequent_words.py:135-160):
    drop the top `skip_first_n` as stopwords, drop words shorter than
    `min_char_len`, take the next `n_words` by frequency."""
    non_stop = counts.copy()
    for w, _ in counts.most_common(skip_first_n):
        del non_stop[w]
    for w in [w for w in non_stop if len(w) < min_char_len]:
        del non_stop[w]
    return [w for w, _ in non_stop.most_common(n_words)]


def select_embedding_commands(
    frequent_words_dir,
    min_clips: int = 2200,
) -> Dict[str, List[Tuple[str, str]]]:
    """{lang: [(word, clips_dir)]} for words with > min_clips extracted wavs
    (reference multi_language_embedding_data.py:29-44). Duplicate words
    across languages are kept per-language here; dedup at manifest time."""
    frequent_words_dir = Path(frequent_words_dir)
    per_lang: Dict[str, List[Tuple[str, str]]] = {}
    for lang in sorted(os.listdir(frequent_words_dir)):
        clips = frequent_words_dir / lang / "clips"
        if not clips.is_dir():
            continue
        per_lang[lang] = []
        for word in sorted(os.listdir(clips)):
            wavs = glob.glob(str(clips / word / "*.wav"))
            if len(wavs) > min_clips:
                per_lang[lang].append((word, str(clips / word)))
    return per_lang


def write_timing_csvs(
    timings: Dict[str, List[Tuple[str, float, float]]], dest_dir
) -> None:
    """Persist word timings as per-word CSVs `clip_id,start_s,end_s`
    (the timings/ directory consumed by the context-padded variant,
    multilingual_embedding_data_w_context.py:44-61)."""
    import csv

    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    for word, rows in timings.items():
        with open(dest_dir / f"{word}.csv", "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["clip_id", "start_s", "end_s"])
            w.writerows(rows)


def read_timing_csv(path) -> Dict[str, Tuple[float, float]]:
    """{clip_id: (start_s, end_s)} keeping the FIRST occurrence per clip
    (reference :49-60 skips duplicate ids)."""
    import csv

    out: Dict[str, Tuple[float, float]] = {}
    with open(path) as fh:
        reader = csv.reader(fh)
        next(reader)
        for row in reader:
            if row[0] not in out:
                out[row[0]] = (float(row[1]), float(row[2]))
    return out


def repoint_manifest(files: Sequence[str], old_root, new_root) -> List[str]:
    """Re-point manifest entries from one extraction tree to another (e.g.
    no-context clips -> context-padded clips), preserving word/clip layout.
    Raises if a target is missing — the merge must be complete."""
    old_root, new_root = Path(old_root), Path(new_root)
    out = []
    for f in files:
        rel = Path(f).relative_to(old_root)
        target = new_root / rel
        if not target.exists():
            raise FileNotFoundError(f"context variant missing: {target}")
        out.append(str(target))
    return out


def make_embedding_manifests(
    word_dirs: Dict[str, str],
    dest_dir,
    val_fraction: float = 0.1,
    seed: int = 0,
    max_clips_per_word: Optional[int] = None,
) -> Dict[str, List[str]]:
    """Write commands.txt / train_files.txt / val_files.txt.

    word_dirs: {command: clips_dir}. Per word: shuffle, take
    `max_clips_per_word` (the reference caps at ~2200/word,
    multi_language_embedding_data.py:60-74), split off `val_fraction`.
    Asserts train/val disjointness (reference :182-184).
    """
    rng = np.random.default_rng(seed)
    dest_dir = Path(dest_dir)
    commands = sorted(word_dirs)
    train_files: List[str] = []
    val_files: List[str] = []
    for word in commands:
        wavs = sorted(glob.glob(os.path.join(word_dirs[word], "*.wav")))
        assert wavs, f"no clips for {word}"
        wavs = list(rng.permutation(wavs))
        if max_clips_per_word is not None:
            wavs = wavs[:max_clips_per_word]
        n_val = int(len(wavs) * val_fraction)
        val_files.extend(wavs[:n_val])
        train_files.extend(wavs[n_val:])

    overlap = set(train_files) & set(val_files)
    assert not overlap, f"train/val overlap: {sorted(overlap)[:5]}"

    write_lines(dest_dir / "commands.txt", commands)
    write_lines(dest_dir / "train_files.txt", train_files)
    write_lines(dest_dir / "val_files.txt", val_files)
    return {"commands": commands, "train_files": train_files,
            "val_files": val_files}
