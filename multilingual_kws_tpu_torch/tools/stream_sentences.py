"""Corpus-based streaming-test synthesis (targets interleaved with sentences).

Equivalent of reference embedding/generate_stream_sentences.py: choose target
occurrences (with forced-alignment timings) plus non-target sentences, build
one long wav by concatenation, and emit streaming_labels.txt with the target
start times in ms (:144-245). Audio assembly is native (utils/audio_ops.py)
instead of sox.Combiner.

The pure-synthetic variant (tones, for tests) lives in tools/stream_synth.py;
this module handles real corpora.

The port's own copy of ``multilingual_kws_tpu/tools/stream_sentences.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.manifests import write_lines
from ..utils.audio_ops import concat, fade, read_audio_any, trim
from ..utils.wav import write_wav
from . import word_extraction


def select_samples(
    target_word: str,
    timings: Dict[str, List[Tuple[str, float, float]]],
    lang_isocode: str,
    alignment_basedir,
    num_samples_for_streaming_wav: int = 100,
    num_shots: int = 5,
    num_val: int = 30,
    rng: Optional[np.random.Generator] = None,
) -> Dict:
    """Split target occurrences into shots / val / stream components and pair
    each stream target with a non-target sentence (reference :69-121)."""
    rng = rng or np.random.default_rng()
    need = num_samples_for_streaming_wav + num_shots + num_val
    occs = timings[target_word]
    ix = rng.choice(len(occs), need, replace=False)
    samples = [occs[i] for i in ix]
    assert len({s[0] for s in samples}) == need, (
        "an mp3 was selected with multiple targets in the same sentence"
    )
    shots = samples[:num_shots]
    val = samples[num_shots : num_shots + num_val]
    target_stream = samples[num_shots + num_val :]

    non_targets = word_extraction.random_non_target_sentences(
        num_sentences=len(target_stream),
        words_to_exclude={target_word},
        lang_isocode=lang_isocode,
        alignment_basedir=alignment_basedir,
        rng=rng,
    )
    wav_data = []
    for tgt, nt in zip(target_stream, non_targets):
        wav_data.append(
            dict(is_target=True, clip=tgt[0], start_s=tgt[1], end_s=tgt[2])
        )
        wav_data.append(dict(is_target=False, clip=nt))
    return dict(
        shot_targets=shots,
        val_targets=val,
        wav_data=wav_data,
        target_stream=target_stream,
        non_targets=non_targets,
    )


def generate_stream_and_labels(
    dest_dir,
    target_word: str,
    wav_data: Sequence[Dict],
    clips_dir,
    clip_suffix: str = ".mp3",
    sample_rate: int = 16000,
    stream_name: str = "streaming_test.wav",
    labels_name: str = "streaming_labels.txt",
) -> Tuple[Path, Path]:
    """Assemble the long wav + ground-truth label file (reference :144-245).

    wav_data entries: {is_target, clip, [start_s, end_s]}; target entries are
    cut to a 1 s window centered on the word, non-targets keep the full
    sentence. Labels are "<target>, <start_ms>" at each target clip's start
    position in the stream.
    """
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    clips_dir = Path(clips_dir)

    pieces: List[np.ndarray] = []
    labels: List[str] = []
    cursor = 0
    for item in wav_data:
        path = clips_dir / (str(item["clip"]) + clip_suffix)
        audio = read_audio_any(path, sample_rate)
        if item["is_target"]:
            duration = audio.shape[0] / sample_rate
            a, b = word_extraction.extract_one_second(
                duration, item["start_s"], item["end_s"]
            )
            audio = fade(trim(audio, sample_rate, a, b), sample_rate)
            labels.append(f"{target_word}, {int(cursor * 1000 / sample_rate)}")
        pieces.append(audio)
        cursor += audio.shape[0]

    stream = concat(pieces)
    wav_path = dest_dir / stream_name
    labels_path = dest_dir / labels_name
    write_wav(wav_path, stream, sample_rate)
    write_lines(labels_path, labels)
    return wav_path, labels_path
