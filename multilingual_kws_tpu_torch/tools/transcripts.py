"""Transcript-driven real-data stream construction (Luganda-style case study).

The reference's Luganda case study builds its evaluation streams from a
real transcribed radio corpus rather than synthetic clips:

- `luganda/luganda_multitarget_data.py` scans a `transcripts.csv`
  (`wav_filename,wav_filesize,transcript`), splits clips into
  keyword-bearing targets vs keyword-free non-targets, pulls per-keyword
  occurrence times from forced-alignment TextGrids, interleaves
  target/non-target clips into one long stream wav, and writes
  groundtruth.json / full_transcript.json / groundtruth_labels.txt /
  keyword_list.txt.
- `luganda/luganda_nontarget.py:29-70` builds a target-free stream for
  isolated false-accept measurement.
- `luganda/luganda.py:761` (`transcript_by_offset`) maps a detection time
  back to the transcript of the clip it landed in, flagging certain false
  positives (clips whose transcript has no keyword occurrence).

This module provides the same capability with no sox/pydub/textgrid
dependencies: wav IO via utils/wav, resampling via utils/audio_ops, and
TextGrids via tools/textgrid. Artifact contracts (file names, JSON keys,
"keyword,time_ms" label lines) match the reference so downstream
consumers (stream engine, tpr_fpr, visualizer) work unchanged.

The port's own copy of ``multilingual_kws_tpu/tools/transcripts.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils import audio_ops
from ..utils.wav import read_wav, write_wav
from .textgrid import read_textgrid


@dataclass
class WavTranscript:
    """One transcribed clip (reference luganda/luganda_info.py:6-13)."""

    wav: str
    transcript: str
    keyword: Optional[str] = None
    occurences_s: List[Tuple[float, float]] = field(default_factory=list)
    tgfile: Optional[str] = None


@dataclass
class MultiTargetWavTranscript:
    """Clip possibly containing several keywords, each with aligned times
    (reference luganda/luganda_multitarget_data.py:57-64)."""

    wav: str
    transcript: str
    keywords: Optional[List[str]] = None
    occurences_s: List[Dict[str, float]] = field(default_factory=list)
    tgfile: Optional[str] = None


def load_transcripts_csv(
    csv_path, clips_root=None, require_exists: bool = True
) -> List[WavTranscript]:
    """Parse the corpus CSV (`wav_filename,wav_filesize,transcript` — the
    Makerere uliza-clips layout; a 2-column `wav_filename,transcript`
    variant is accepted)."""
    csv_path = Path(csv_path)
    root = Path(clips_root) if clips_root is not None else csv_path.parent
    out = []
    with open(csv_path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        t_col = len(header) - 1  # transcript is the last column
        for row in reader:
            if not row:
                continue
            wav = root / row[0]
            if require_exists and not wav.is_file():
                raise FileNotFoundError(wav)
            out.append(WavTranscript(wav=str(wav), transcript=row[t_col]))
    return out


def split_by_keywords(
    entries: Iterable[WavTranscript],
    keywords: Set[str],
    exclude: Optional[Set[str]] = None,
) -> Tuple[List[WavTranscript], List[WavTranscript]]:
    """(clips whose transcript mentions a keyword, keyword-free clips).

    `exclude` extends the non-target filter with spelling variants /
    plurals that should disqualify a clip from the non-target pool even
    though they are not evaluation targets (luganda_nontarget.py:44)."""
    block = set(keywords) | set(exclude or ())
    with_kw, without = [], []
    for e in entries:
        words = set(e.transcript.split())
        if words & set(keywords):
            with_kw.append(e)
        elif not (words & block):
            without.append(e)
    return with_kw, without


def keyword_counts(entries: Iterable[WavTranscript], keywords: Set[str]) -> Dict[str, int]:
    counts = {w: 0 for w in keywords}
    for e in entries:
        for w in e.transcript.split():
            if w in counts:
                counts[w] += 1
    return counts


def timings_from_alignments(
    alignments_dir,
    clips_dir,
    keywords: Set[str],
) -> List[MultiTargetWavTranscript]:
    """Collect keyword occurrence times from forced-alignment TextGrids.

    Layout (reference luganda_multitarget_data.py:85-124): one directory
    per clip id under `alignments_dir` containing `<id>.TextGrid`; the
    clip and its `.lab` transcript live at `clips_dir/<id>/<id>.{wav,lab}`.
    Clips whose alignment failed (no directory) are skipped.
    """
    alignments_dir = Path(alignments_dir)
    clips_dir = Path(clips_dir)
    out = []
    for a in sorted(p.name for p in alignments_dir.iterdir() if p.is_dir()):
        wav = clips_dir / a / f"{a}.wav"
        lab = clips_dir / a / f"{a}.lab"
        if not lab.is_file():
            continue
        transcript = lab.read_text().strip()
        if not (set(transcript.split()) & set(keywords)):
            continue
        tgfile = alignments_dir / a / f"{a}.TextGrid"
        occurences: List[Dict[str, float]] = []
        present = set()
        for iv in read_textgrid(tgfile):
            if iv.mark not in keywords:
                continue
            present.add(iv.mark)
            occurences.append(
                dict(keyword=iv.mark, start_s=iv.minTime, end_s=iv.maxTime)
            )
        if not occurences:
            raise ValueError(f"{a}: transcript has a keyword but no aligned interval")
        out.append(
            MultiTargetWavTranscript(
                wav=str(wav), transcript=transcript,
                keywords=sorted(present), occurences_s=occurences,
                tgfile=str(tgfile),
            )
        )
    return out


def _load_clip(path, sample_rate: int) -> np.ndarray:
    audio, sr = read_wav(path)
    if sr != sample_rate:
        audio = audio_ops.resample(audio, sr, sample_rate)
    return audio.astype(np.float32)


def assemble_multitarget_stream(
    targets: Sequence[MultiTargetWavTranscript],
    non_targets: Sequence[WavTranscript],
    out_dir,
    num_targets: Optional[int] = None,
    sample_rate: int = 16000,
    seed: int = 0,
) -> Dict:
    """Interleave target and non-target clips into one evaluation stream.

    Writes the reference's artifact set (luganda_multitarget_data.py:
    172-267): stream.wav, groundtruth.json, full_transcript.json,
    groundtruth_labels.txt ("keyword,time_ms" lines consumed by
    stream/stats + tpr_fpr), keyword_list.txt. Returns the groundtruth
    dict."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = len(targets) if num_targets is None else min(num_targets, len(targets))
    ixs = rng.choice(len(targets), n, replace=False)

    pieces: List[np.ndarray] = []
    stream_data: List[Dict] = []
    transcript: List[Dict] = []
    gt_times: List[Dict] = []
    total_s = 0.0
    used_nontargets = set()
    for ix in ixs:
        tgt = targets[int(ix)]
        nt_ix = int(rng.integers(len(non_targets)))
        used_nontargets.add(nt_ix)
        nt = non_targets[nt_ix]

        t_audio = _load_clip(tgt.wav, sample_rate)
        n_audio = _load_clip(nt.wav, sample_rate)
        t_dur = t_audio.shape[0] / sample_rate
        n_dur = n_audio.shape[0] / sample_rate

        for o in tgt.occurences_s:
            gt_times.append(
                dict(keyword=o["keyword"], time_ms=(total_s + o["start_s"]) * 1000)
            )
        transcript.append(
            dict(transcript_type="target", transcript=tgt.transcript,
                 start=total_s, end=total_s + t_dur)
        )
        transcript.append(
            dict(transcript_type="nontarget", transcript=nt.transcript,
                 start=total_s + t_dur, end=total_s + t_dur + n_dur)
        )
        td = asdict(tgt)
        td["duration_s"] = t_dur
        nd = asdict(nt)
        nd["duration_s"] = n_dur
        stream_data.extend([td, nd])
        pieces.extend([t_audio, n_audio])
        total_s += t_dur + n_dur

    waveform = audio_ops.concat(pieces)
    write_wav(out_dir / "stream.wav", waveform, sample_rate)

    keywords = sorted({g["keyword"] for g in gt_times})
    groundtruth = dict(
        groundtruth_target_times_ms=gt_times,
        stream_data=stream_data,
        keyword_wav_transcripts=[asdict(t) for t in targets],
        non_targets=[asdict(nt) for nt in non_targets],
        ixs=[int(i) for i in ixs],
    )
    if len(used_nontargets) < n:
        # set BEFORE the dump so the on-disk artifact and the returned
        # dict agree (round-2 advisor finding)
        groundtruth["duplicate_nontargets"] = n - len(used_nontargets)
    (out_dir / "groundtruth.json").write_text(json.dumps(groundtruth))
    (out_dir / "full_transcript.json").write_text(json.dumps(transcript))
    with open(out_dir / "groundtruth_labels.txt", "w") as fh:
        for g in gt_times:
            fh.write(f"{g['keyword']},{g['time_ms']}\n")
    (out_dir / "keyword_list.txt").write_text("\n".join(keywords) + "\n")
    return groundtruth


def assemble_nontarget_stream(
    non_targets: Sequence[WavTranscript],
    out_dir,
    num_wavs: int = 160,
    sample_rate: int = 16000,
    seed: int = 0,
) -> Dict:
    """Target-free stream for isolated false-accept measurement
    (luganda_nontarget.py:29-70). Writes nontarget_stream.wav +
    nontarget_groundtruth.json (empty target times) + an empty
    groundtruth_labels.txt."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    pieces, stream_data = [], []
    total_s = 0.0
    for _ in range(num_wavs):
        nt = non_targets[int(rng.integers(len(non_targets)))]
        audio = _load_clip(nt.wav, sample_rate)
        dur = audio.shape[0] / sample_rate
        nd = asdict(nt)
        nd["duration_s"] = dur
        stream_data.append(nd)
        pieces.append(audio)
        total_s += dur
    write_wav(out_dir / "nontarget_stream.wav", audio_ops.concat(pieces), sample_rate)
    groundtruth = dict(
        groundtruth_target_times_ms=[],
        stream_data=stream_data,
        total_duration_s=total_s,
    )
    (out_dir / "nontarget_groundtruth.json").write_text(json.dumps(groundtruth))
    (out_dir / "groundtruth_labels.txt").write_text("")
    return groundtruth


def transcript_by_offset(time_ms: float, groundtruth: Dict) -> Optional[Dict]:
    """Locate the stream clip containing a detection time and annotate it
    (reference luganda/luganda.py:761-778, returned instead of printed).

    Returns dict(entry, offset_in_clip_ms, pct_in_clip, decorated,
    certain_false_positive) or None when time_ms falls past the stream
    end. `certain_false_positive` is True when the containing clip has no
    keyword occurrence at all."""
    offset_ms = 0.0
    for entry in groundtruth["stream_data"]:
        duration_ms = entry["duration_s"] * 1000
        if time_ms < offset_ms + duration_ms:
            off = time_ms - offset_ms
            kws = set(entry.get("keywords") or ([entry["keyword"]] if entry.get("keyword") else []))
            decorated = " ".join(
                f"[::{w}::]" if w in kws else w
                for w in entry["transcript"].split()
            )
            return dict(
                entry=entry,
                offset_in_clip_ms=off,
                pct_in_clip=off / duration_ms if duration_ms else 0.0,
                decorated=decorated,
                certain_false_positive=len(entry.get("occurences_s") or []) == 0,
            )
        offset_ms += duration_ms
    return None
