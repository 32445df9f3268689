"""Keyword-clip extraction from aligned speech corpora.

Equivalent of reference embedding/word_extraction.py: Common Voice word
frequency counts, mp3->TextGrid filemaps, parallel forced-alignment timing
extraction, non-target sentence sampling, 1-second centered extraction
windows, and the sox-based clip extraction pipeline (resample 48k->16k, trim,
25 ms fades, pad) — reimplemented on the native audio ops in
utils/audio_ops.py (no sox) and the dependency-free TextGrid parser in
tools/textgrid.py.

Host/process parallelism is kept (the one parallelism the reference has,
SURVEY.md section 2.2): timing extraction fans out over a process pool,
whose workers are spawned (the parent may hold threads, which a fork would
copy in whatever state they are).

The port's own copy of ``multilingual_kws_tpu/tools/word_extraction.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import functools
import multiprocessing
import os
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils.audio_ops import fade, pad, read_audio_any, trim
from ..utils.wav import write_wav
from .textgrid import TextGridError, read_textgrid


def wordcounts(csvpath, skip_header: bool = True, transcript_column: int = 2) -> Counter:
    """Word frequencies from a Common Voice validated.csv
    (reference word_extraction.py:22-35)."""
    counts: Counter = Counter()
    with open(csvpath) as fh:
        reader = csv.reader(fh)
        if skip_header:
            next(reader)
        for row in reader:
            for w in row[transcript_column].split():
                counts[w] += 1
    return counts


def generate_filemap(lang_isocode: str, alignment_basedir) -> Dict[str, str]:
    """mp3 basename -> textgrid path (reference :38-54)."""
    filemap: Dict[str, str] = {}
    for root, _dirs, files in os.walk(
        Path(alignment_basedir) / lang_isocode / "alignments"
    ):
        for tg in files:
            name = os.path.splitext(tg)[0]
            if name in filemap:
                raise ValueError(f"{name} already present in filemap")
            filemap[name] = os.path.join(root, tg)
    return filemap


def _extract_timings_row(
    words_to_search_for: Set[str],
    mp3_to_textgrid: Dict[str, str],
    row: Sequence[str],
) -> Tuple[List[Tuple[str, str, float, float]], List[Tuple[str, str]]]:
    """Per-CSV-row worker: [(word, mp3name, start_s, end_s)], [notfound]."""
    timings, notfound = [], []
    mp3name = os.path.splitext(row[0])[0]
    for word in row[2].split():
        if word not in words_to_search_for:
            continue
        tgf = mp3_to_textgrid.get(mp3name)
        if tgf is None:
            notfound.append((mp3name, word))
            continue
        try:
            intervals = read_textgrid(tgf)
        except TextGridError:
            notfound.append((mp3name, word))
            continue
        for iv in intervals:
            if iv.mark == word:
                timings.append((word, mp3name, iv.minTime, iv.maxTime))
    return timings, notfound


def generate_wordtimings(
    words_to_search_for: Set[str],
    mp3_to_textgrid: Dict[str, str],
    lang_isocode: str,
    alignment_basedir,
    num_workers: Optional[int] = None,
):
    """{word: [(mp3name, start_s, end_s)]}, [(mp3name, word) not found].

    Reference :83-124 — process-pool parallel TextGrid parsing over the
    validated.csv rows.
    """
    csvpath = Path(alignment_basedir) / lang_isocode / "validated.csv"
    with open(csvpath) as fh:
        rows = list(csv.reader(fh.read().splitlines()))[1:]

    worker = functools.partial(
        _extract_timings_row, set(words_to_search_for), mp3_to_textgrid
    )
    timings: Dict[str, List] = {w: [] for w in words_to_search_for}
    notfound: List[Tuple[str, str]] = []
    if num_workers == 0:  # in-process (tests / tiny corpora)
        results = map(worker, rows)
        for ts, nf in results:
            for word, mp3name, s, e in ts:
                timings[word].append((mp3name, s, e))
            notfound.extend(nf)
    else:
        with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
            for ts, nf in pool.imap_unordered(worker, rows, chunksize=4000):
                for word, mp3name, s, e in ts:
                    timings[word].append((mp3name, s, e))
                notfound.extend(nf)
    return timings, notfound


def random_non_target_sentences(
    num_sentences: int,
    words_to_exclude: Set[str],
    lang_isocode: str,
    alignment_basedir,
    rng: Optional[np.random.Generator] = None,
) -> List[str]:
    """mp3 basenames of sentences containing none of the excluded words
    (reference :127-160)."""
    rng = rng or np.random.default_rng()
    csvpath = Path(alignment_basedir) / lang_isocode / "validated.csv"
    with open(csvpath) as fh:
        rows = list(csv.reader(fh.read().splitlines()))[1:]
    if len(rows) < num_sentences:
        raise ValueError("not enough data in csv")
    order = rng.permutation(len(rows))
    selected = []
    for ix in order:
        row = rows[ix]
        if any(w in words_to_exclude for w in row[2].split()):
            continue
        selected.append(os.path.splitext(row[0])[0])
        if len(selected) == num_sentences:
            break
    if len(selected) < num_sentences:
        raise ValueError("not enough usable sentences")
    return selected


def full_transcription_timings(textgrid_path) -> List[Tuple[str, float, float]]:
    """[(word, start, end)] for a full textgrid (reference :164-173);
    blank marks denote pauses."""
    return [(iv.mark, iv.minTime, iv.maxTime) for iv in read_textgrid(textgrid_path)]


def extract_one_second(duration_s: float, start_s: float, end_s: float):
    """One second around the midpoint, clamped to clip bounds
    (reference :175-190)."""
    if duration_s < 1:
        return (0, duration_s)
    center = start_s + (end_s - start_s) / 2.0
    new_start, new_end = center - 0.5, center + 0.5
    if new_end > duration_s:
        new_end = duration_s
        new_start = duration_s - 1.0
    if new_start < 0:
        new_start = 0
        new_end = min(duration_s, new_start + 1.0)
    return (new_start, new_end)


def extract_shot(
    clip_path,
    start_s: float,
    end_s: float,
    dest_dir,
    include_context: bool,
    sample_rate: int = 16000,
) -> Path:
    """Extract a 1 s keyword shot as 16 kHz wav with 25 ms fades.

    Native replacement of extract_shot_from_mp3 (reference :193-231): decode/
    resample (sox convert), trim, fade 25 ms, symmetric pad to 1 s when the
    utterance is shorter and context is excluded.
    """
    clip_path = Path(clip_path)
    if not clip_path.exists():
        raise ValueError(f"could not find {clip_path}")
    dest_dir = Path(dest_dir)
    if not dest_dir.is_dir():
        raise ValueError(f"{dest_dir} does not exist")
    dest = dest_dir / (clip_path.stem + ".wav")
    if dest.exists():
        raise ValueError(f"already exists: {dest}")

    audio = read_audio_any(clip_path, sample_rate)
    duration = audio.shape[0] / sample_rate
    if end_s - start_s < 1 and not include_context:
        pad_amt = (1.0 - (end_s - start_s)) / 2.0
    else:
        start_s, end_s = extract_one_second(duration, start_s, end_s)
        pad_amt = 0.0

    out = trim(audio, sample_rate, start_s, end_s)
    out = fade(out, sample_rate, 0.025, 0.025)
    if pad_amt > 0:
        out = pad(out, sample_rate, pad_amt, pad_amt)
    write_wav(dest, out, sample_rate)
    return dest
