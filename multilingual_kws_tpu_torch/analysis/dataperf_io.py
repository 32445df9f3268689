"""DataPerf sample serialization + validation-filter flow.

Completes the DataPerf tail (reference notebooks):

- `notebooks/dataperf_experiments.py:259-300`: embedding samples serialized
  two ways — a protobuf `Samples` message (the dataperf-speech-example
  submission format) and a compressed npz of object rows
  `[sample_type, clip_id, vector]`.
- `notebooks/dataperf_validation_filter.py:24-31` (loudnorm) and `:44-105`
  (target_validation_filter): EBU-R128 loudness normalization of listening
  data, then removal of human-rejected clips from an experiment's eval
  yaml + embedding table, with 1:1 consistency asserts.

The protobuf writer/reader below emits the wire format directly (no
protoc dependency) for the schema used by the reference flow:

    message Samples { repeated Sample samples = 1; }
    message Sample  { SampleType sample_type = 1;      // 0 target, 1 nontarget
                      string sample_id = 2;
                      repeated float mswc_embedding_vector = 3; }  // packed

Ratings CSVs are the `[clip, metric, rating]` rows produced by
api/labeling.py (and the reference's label_directory_dataperf.py).

The port's own copy of ``multilingual_kws_tpu/analysis/dataperf_io.py`` (numpy only): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

SAMPLE_TYPES = ("target", "nontarget")


@dataclass(frozen=True)
class Sample:
    sample_type: str  # "target" | "nontarget"
    sample_id: str
    vector: np.ndarray


# ---------------------------------------------------------------------------
# npz serialization (dataperf_experiments.py:283-300)
# ---------------------------------------------------------------------------


def save_npz(path, samples: Sequence[Sample], key: str = "train") -> None:
    """Object-array rows [sample_type, clip_id, vector], np.savez_compressed."""
    rows = np.array(
        [[s.sample_type, s.sample_id, np.asarray(s.vector, np.float32)]
         for s in samples],
        dtype=object,
    )
    np.savez_compressed(path, **{key: rows})


def load_npz(path, key: str = "train") -> List[Sample]:
    rows = np.load(path, allow_pickle=True)[key]
    return [
        Sample(sample_type=str(r[0]), sample_id=str(r[1]),
               vector=np.asarray(r[2], np.float32))
        for r in rows
    ]


# ---------------------------------------------------------------------------
# protobuf wire format (dataperf_experiments.py:259-282)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _sample_pb(s: Sample) -> bytes:
    out = bytearray()
    type_id = SAMPLE_TYPES.index(s.sample_type)
    if type_id:  # proto3 omits zero-valued scalars
        out += _varint(1 << 3 | 0) + _varint(type_id)
    sid = s.sample_id.encode()
    out += _varint(2 << 3 | 2) + _varint(len(sid)) + sid
    vec = np.asarray(s.vector, np.float32)
    packed = struct.pack(f"<{vec.size}f", *vec.tolist())
    out += _varint(3 << 3 | 2) + _varint(len(packed)) + packed
    return bytes(out)


def save_pb(path, samples: Sequence[Sample]) -> None:
    out = bytearray()
    for s in samples:
        body = _sample_pb(s)
        out += _varint(1 << 3 | 2) + _varint(len(body)) + body
    Path(path).write_bytes(bytes(out))


def _parse_sample(body: bytes) -> Sample:
    i = 0
    type_id = 0
    sid = ""
    vec = np.zeros(0, np.float32)
    while i < len(body):
        tag, i = _read_varint(body, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(body, i)
            if field == 1:
                type_id = val
        elif wire == 2:
            ln, i = _read_varint(body, i)
            chunk = body[i : i + ln]
            i += ln
            if field == 2:
                sid = chunk.decode()
            elif field == 3:
                vec = np.frombuffer(chunk, dtype="<f4").astype(np.float32)
        elif wire == 5:  # unpacked float (non-packed encoders)
            if field == 3:
                vec = np.append(vec, struct.unpack("<f", body[i : i + 4])[0])
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return Sample(SAMPLE_TYPES[type_id], sid, vec)


def load_pb(path) -> List[Sample]:
    buf = Path(path).read_bytes()
    i = 0
    out = []
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        assert tag >> 3 == 1 and tag & 7 == 2, "expected Samples.samples field"
        ln, i = _read_varint(buf, i)
        out.append(_parse_sample(buf[i : i + ln]))
        i += ln
    return out


def split_by_type(samples: Sequence[Sample]) -> Dict[str, List[Sample]]:
    out: Dict[str, List[Sample]] = {t: [] for t in SAMPLE_TYPES}
    for s in samples:
        out[s.sample_type].append(s)
    return out


# ---------------------------------------------------------------------------
# loudness normalization (dataperf_validation_filter.py:24-31)
# ---------------------------------------------------------------------------


def loudnorm(src, dest, sample_rate: int = 16000) -> Path:
    """EBU R128 two-pass-style loudness normalization via ffmpeg
    (loudnorm=I=-16:TP=-1.5:LRA=11, pcm_s16le mono). Gated on ffmpeg being
    installed — listening-data prep only, never the training path."""
    import shutil
    import subprocess

    if not shutil.which("ffmpeg"):
        raise RuntimeError("loudnorm requires ffmpeg on PATH")
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-i", str(src), "-af", "loudnorm=I=-16:TP=-1.5:LRA=11",
         "-c:a", "pcm_s16le", "-ar", str(sample_rate), "-ac", "1", "-y",
         str(dest)],
        check=True, capture_output=True,
    )
    return dest


# ---------------------------------------------------------------------------
# validation filter (dataperf_validation_filter.py:44-105)
# ---------------------------------------------------------------------------


def read_ratings_csv(path) -> Dict[str, str]:
    """api/labeling.py ratings CSV -> {clip_id: rating}. Accepts both the
    3-column [clip, metric, rating] layout and the reference's bare
    [clip, rating]."""
    out = {}
    with open(path, newline="") as fh:
        for row in csv.reader(fh):
            if not row:
                continue
            out[row[0]] = row[-1]
    return out


def target_validation_filter(
    target: str,
    eval_yaml: Dict,
    ratings: Dict[str, str],
    embeddings: Dict[str, np.ndarray],
) -> Tuple[Dict, Dict[str, np.ndarray], Dict]:
    """Drop human-rejected clips from one target's eval set.

    eval_yaml: {"targets": {target: [clip_id, ...], ...}}
    ratings:   {clip_id: "good"|"bad"} covering exactly the target's clips
    embeddings:{clip_id: vector} covering exactly the target's clips

    Returns (cleaned eval_yaml, cleaned embeddings, report). Asserts the
    1:1 consistency between the three inputs like the reference does before
    touching anything.
    """
    eval_samples = list(eval_yaml["targets"][target])
    emb_ids = {c for c in embeddings}
    assert set(eval_samples) == emb_ids, "mismatch between embeddings and yaml"
    assert set(eval_samples) == set(ratings), "mismatch between yaml and ratings"

    bad = sorted(c for c, r in ratings.items() if r == "bad")
    good = [c for c in eval_samples if ratings[c] != "bad"]

    cleaned_yaml = dict(eval_yaml)
    cleaned_yaml["targets"] = dict(eval_yaml["targets"])
    cleaned_yaml["targets"][target] = good
    cleaned_emb = {c: v for c, v in embeddings.items() if c not in set(bad)}
    assert len(good) == len(cleaned_emb), "cleaned mismatch"

    report = dict(
        target=target,
        total=len(eval_samples),
        bad=len(bad),
        good=len(good),
        percent_good=100.0 * len(good) / max(len(eval_samples), 1),
        removed=bad,
    )
    return cleaned_yaml, cleaned_emb, report


# ---------------------------------------------------------------------------
# low/medium-resource language configs + keyword selection
# (notebooks/dataperf_med_low.py — MSWC resource tiers and the
# pick-frequent-keywords flow it runs by hand over HF datasets)
# ---------------------------------------------------------------------------

# ISO 639-1 sets from dataperf_med_low.py:12-37 (restricted to 2-letter
# codes exactly as the reference does at :35-36)
LOW_RESOURCE_LANGUAGES = (
    "ar", "as", "br", "cv", "dv", "ka", "gn", "el", "ha", "ia",
    "lv", "lt", "mt", "or", "ro", "sl", "sk", "ta", "vi",
)
MEDIUM_RESOURCE_LANGUAGES = (
    "cs", "nl", "et", "eo", "id", "ky", "mn", "pt", "tt", "tr", "uk",
)


def keyword_counts(clips: Sequence[Tuple[str, str]]) -> Dict[str, int]:
    """Count clips per keyword from (keyword, split) pairs, like the
    reference's Counter over ds['validation'] (dataperf_med_low.py:69-75).
    Pass e.g. [(kw, 'validation'), ...]; only rows whose split matches
    'validation' count (pass split=None rows to count everything)."""
    import collections

    c: Dict[str, int] = collections.Counter()
    for kw, split in clips:
        if split in (None, "validation"):
            c[kw] += 1
    return dict(c)


def select_experiment_keywords(
    counts: Dict[str, int], n: int = 5, min_count: int = 100
) -> List[str]:
    """Most-frequent keywords with at least min_count validation clips —
    the selection rule behind the reference's hand-picked id/pt/nl keyword
    lists (dataperf_med_low.py:77-111: each chosen keyword has >=100 train
    clips)."""
    eligible = [(kw, c) for kw, c in counts.items() if c >= min_count]
    eligible.sort(key=lambda t: (-t[1], t[0]))
    return [kw for kw, _ in eligible[:n]]
