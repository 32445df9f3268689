"""Per-speaker few-shot evaluation.

Counterpart of ``multilingual_kws_tpu/analysis/per_speaker.py`` (reference
embedding/librispeech_eval.py): few-shot fine-tune a keyword on ONE
speaker's utterances and evaluate on that speaker's held-out clips and on
the other speakers', measuring speaker-dependent against
speaker-independent few-shot quality. Fine-tunes and evaluations run on
``device`` (the port's ``transfer_learn`` and ``train/evaluate.py``).
"""

from __future__ import annotations

import copy
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from .. import resolve_device
from ..train.evaluate import evaluate_files_multiclass
from ..train.finetune import transfer_learn


def group_by_speaker(
    files: Sequence[str],
    speaker_fn: Optional[Callable[[str], str]] = None,
) -> Dict[str, List[str]]:
    """{speaker_id: [files]}. Default speaker_fn handles LibriSpeech
    (<speaker>-<chapter>-<utt>.wav) and GSC (<speaker>_nohash_<n>.wav)."""
    def default_speaker(path: str) -> str:
        stem = Path(path).stem
        if "_nohash_" in stem:
            return stem.split("_nohash_")[0]
        m = re.match(r"^(\d+)-", stem)
        return m.group(1) if m else stem.split("_")[0]

    speaker_fn = speaker_fn or default_speaker
    out: Dict[str, List[str]] = defaultdict(list)
    for f in files:
        out[speaker_fn(str(f))].append(str(f))
    return dict(out)


def per_speaker_eval(
    target: str,
    files_by_speaker: Dict[str, List[str]],
    unknown_files: Sequence[str],
    bg_datadir,
    num_shots: int = 5,
    min_clips: int = 8,
    base_model_path=None,
    base_params=None,
    base_batch_stats=None,
    model=None,
    num_epochs: int = 4,
    batch_size: int = 16,
    primary_lr: float = 1e-3,
    seed: int = 0,
    verbose: int = 0,
    device="cuda",
) -> List[Dict]:
    """For each speaker with >= min_clips: fine-tune on their first
    num_shots clips, evaluate (a) same-speaker held-out and (b) all other
    speakers' clips. Returns one record per speaker. ``model``, when given,
    is copied for each speaker's fine-tune (each starts from its weights, as
    each JAX fine-tune starts from the module's seeded init), never trained
    in place."""
    dev = resolve_device(device)
    results = []
    speakers = sorted(s for s, f in files_by_speaker.items() if len(f) >= min_clips)
    for speaker in speakers:
        own = files_by_speaker[speaker]
        train_files = own[:num_shots]
        held_out = own[num_shots:]
        others = [f for s, fs in files_by_speaker.items() if s != speaker for f in fs]
        r = transfer_learn(
            target=target,
            train_files=train_files,
            val_files=held_out,
            unknown_files=list(unknown_files),
            num_epochs=num_epochs,
            num_batches=1,
            batch_size=batch_size,
            primary_lr=primary_lr,
            backprop_into_embedding=False,
            embedding_lr=0,
            base_model_path=base_model_path,
            base_params=base_params,
            base_batch_stats=base_batch_stats,
            bg_datadir=bg_datadir,
            seed=seed,
            verbose=verbose,
            model=copy.deepcopy(model),
            device=dev,
        )
        predict = r.predict_fn()
        same = evaluate_files_multiclass(held_out, 2, predict, device=dev)
        cross = evaluate_files_multiclass(others, 2, predict, device=dev) if others else None

        def acc(res):
            n = len(res["correct"]) + len(res["incorrect"])
            return len(res["correct"]) / n if n else float("nan")

        results.append(
            dict(
                speaker=speaker,
                num_shots=num_shots,
                same_speaker_accuracy=acc(same),
                cross_speaker_accuracy=acc(cross) if cross else float("nan"),
                val_accuracy=r.details["val_accuracy"],
                num_held_out=len(held_out),
                num_cross=len(others),
            )
        )
    return results
