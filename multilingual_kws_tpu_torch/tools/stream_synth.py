"""Synthetic streaming-test generation: long wav + streaming_labels.txt.

First-class test-fixture generator modeled on the reference's
generate_stream_sentences.py:144-245 (which concatenates target clips and
non-target sentences via sox and emits "label, time_ms" lines). Here the
concatenation is pure numpy — no sox needed — and fully deterministic under
a seed, which turns the reference's ad hoc validation recipe into a real
integration-test harness (SURVEY.md section 4).

The port's own copy of ``multilingual_kws_tpu/tools/stream_synth.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..data.manifests import write_lines
from ..utils.wav import write_wav


@dataclass
class StreamSpec:
    """A synthesized stream: waveform + ground-truth target times."""

    waveform: np.ndarray
    sample_rate: int
    labels: List[Tuple[str, int]]  # (label, start_ms)


def synthesize_stream(
    target_name: str,
    target_clips: Sequence[np.ndarray],
    distractor_clips: Sequence[np.ndarray],
    num_targets: int,
    num_distractors: int,
    sample_rate: int = 16000,
    gap_ms_range: Tuple[int, int] = (100, 600),
    noise_rms: float = 0.0,
    seed: int = 0,
) -> StreamSpec:
    """Interleave target and distractor clips with random gaps.

    Targets and distractors are shuffled together; each target occurrence is
    recorded as (target_name, start_ms) matching streaming_labels.txt
    semantics (generate_stream_sentences.py:239-245).
    """
    rng = np.random.default_rng(seed)
    events = [("target", rng.integers(len(target_clips))) for _ in range(num_targets)]
    events += [
        ("distractor", rng.integers(len(distractor_clips)))
        for _ in range(num_distractors)
    ]
    rng.shuffle(events)

    pieces: List[np.ndarray] = []
    labels: List[Tuple[str, int]] = []
    cursor = 0  # samples
    for kind, idx in events:
        gap = int(rng.integers(*gap_ms_range) * sample_rate / 1000)
        pieces.append(np.zeros(gap, np.float32))
        cursor += gap
        clip = (
            target_clips[idx] if kind == "target" else distractor_clips[idx]
        ).astype(np.float32)
        if kind == "target":
            labels.append((target_name, int(cursor * 1000 / sample_rate)))
        pieces.append(clip)
        cursor += clip.shape[0]
    # tail padding so the last clip has a full window after it
    pieces.append(np.zeros(sample_rate, np.float32))
    waveform = np.concatenate(pieces)
    if noise_rms > 0:
        waveform = waveform + rng.normal(0, noise_rms, waveform.shape).astype(
            np.float32
        )
    waveform = np.clip(waveform, -1.0, 1.0).astype(np.float32)
    return StreamSpec(waveform=waveform, sample_rate=sample_rate, labels=labels)


def synthesize_nontarget_stream(
    distractor_clips: Sequence[np.ndarray],
    num_distractors: int,
    sample_rate: int = 16000,
    gap_ms_range: Tuple[int, int] = (100, 600),
    noise_rms: float = 0.0,
    seed: int = 0,
) -> StreamSpec:
    """A stream containing NO target occurrences — for measuring the
    false-accept rate in isolation (reference luganda/luganda_nontarget.py
    :29-70 builds such streams from non-target sentences). Ground-truth
    label list is empty; every detection on it is a false accept."""
    spec = synthesize_stream(
        target_name="_none_",
        target_clips=[np.zeros(1, np.float32)],
        distractor_clips=distractor_clips,
        num_targets=0,
        num_distractors=num_distractors,
        sample_rate=sample_rate,
        gap_ms_range=gap_ms_range,
        noise_rms=noise_rms,
        seed=seed,
    )
    assert spec.labels == []
    return spec


def write_stream(spec: StreamSpec, wav_path, labels_path) -> None:
    """Write stream wav + "label,time_ms" ground-truth file."""
    write_wav(wav_path, spec.waveform, spec.sample_rate)
    write_lines(labels_path, [f"{label}, {ms}" for label, ms in spec.labels])
