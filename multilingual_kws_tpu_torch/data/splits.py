"""Deterministic dataset splits.

The port's own copy of ``multilingual_kws_tpu/data/splits.py`` (stdlib
only): the port imports nothing of the JAX package.

- which_set: the Google speech_commands stable hash split (vendored by the
  reference at notebooks/gsc_comparisons.py:41-56 and
  tf_v1_speechcommands/input_data_fix_bg.py:70) — a clip's split never
  changes as the corpus grows, and all clips from one speaker (the
  `_nohash_` prefix) land in the same split.
- read_mswc_splits: the MSWC `SET,LINK,WORD,VALID,SPEAKER,GENDER` CSV
  contract (reference notebooks/generate_microset.py:44-50, tutorial cell 24).
"""

from __future__ import annotations

import csv
import hashlib
import os
import re
from pathlib import Path
from typing import Dict, List

MAX_NUM_WAVS_PER_CLASS = 2**27 - 1  # ~134M


def which_set(
    filename, validation_percentage: float, testing_percentage: float
) -> str:
    """'training' | 'validation' | 'testing' via stable SHA1 bucketing."""
    base_name = os.path.basename(str(filename))
    hash_name = re.sub(r"_nohash_.*$", "", base_name)
    hashed = hashlib.sha1(hash_name.encode("utf-8")).hexdigest()
    percentage_hash = (int(hashed, 16) % (MAX_NUM_WAVS_PER_CLASS + 1)) * (
        100.0 / MAX_NUM_WAVS_PER_CLASS
    )
    if percentage_hash < validation_percentage:
        return "validation"
    if percentage_hash < testing_percentage + validation_percentage:
        return "testing"
    return "training"


def split_files(
    files, validation_percentage: float = 10.0, testing_percentage: float = 10.0
) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {"training": [], "validation": [], "testing": []}
    for f in files:
        out[which_set(f, validation_percentage, testing_percentage)].append(str(f))
    return out


def read_mswc_splits(splits_csv) -> Dict[str, Dict[str, str]]:
    """{clip_filename: {word, split}} from an MSWC splits CSV
    (SET,LINK,WORD,VALID,SPEAKER,GENDER)."""
    sample2split: Dict[str, Dict[str, str]] = {}
    with open(splits_csv) as fh:
        reader = csv.reader(fh)
        next(reader)  # header
        for row in reader:
            split, clip, word = row[0].lower(), row[1], row[2]
            sample2split[Path(clip).name] = dict(word=word, split=split)
    return sample2split


def train_dev_test(
    word: str, filenames: List[str], sample2split: Dict[str, Dict[str, str]]
) -> Dict[str, List[str]]:
    """Partition a word's sample filenames by MSWC split (reference
    dataperf_test_harness.py:75-93)."""
    out: Dict[str, List[str]] = {"train": [], "dev": [], "test": []}
    for s in filenames:
        index = str(Path(word) / (Path(s).stem + ".wav"))
        split = sample2split[Path(s).name]["split"]
        if split in out:
            out[split].append(index)
    return out
