"""Batch experiment driver: train -> stream pipelines with crash-safe resume.

Counterpart of ``multilingual_kws_tpu/analysis/batch_jobs.py`` (reference
embedding/batch_transfer_learn_streaming.py and the batch driver of
batch_streaming_analysis.py:244-336): the job list is pickled up front, each
job is idempotent (skipped when its result pickles exist), and
``resume_run`` reloads the job list after a crash.

In-process, with no process per job (the reference forked one to give a
Keras session's GPU memory back); a job that fails is caught and its
traceback recorded in the summary. A job fine-tunes and streams on
``device`` (the port's ``transfer_learn`` and ``eval_stream_test``) and
saves its model through the port's checkpoints. The stream pickles hold
numpy and plain Python, and the port's ``StreamFlags``.
"""

from __future__ import annotations

import copy
import os
import pickle
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from .. import resolve_device
from ..stream.engine import StreamTarget, eval_stream_test
from ..train import checkpoints as ckpt
from ..train.finetune import transfer_learn


@dataclass(frozen=True)
class TLData:
    """One train -> stream job (reference TLData,
    batch_transfer_learn_streaming.py:25-38)."""

    train_files: List[str]
    val_files: List[str]
    n_batches: int
    n_epochs: int
    model_dest_dir: str
    primary_lr: float
    backprop_into_embedding: bool
    embedding_lr: float
    target: str
    stream_targets: List[StreamTarget]
    batch_size: int = 64
    with_context: bool = True  # kept for job-record parity


def run_job(
    d: TLData,
    unknown_files: Sequence[str],
    base_model_path,
    bg_datadir,
    verbose: int = 0,
    model=None,
    device="cuda",
) -> Optional[str]:
    """Train the few-shot model of one job and stream-evaluate its targets.

    Idempotent: returns "skipped" when every stream target's result pickle
    already exists (reference train_process, :40-47). ``model``, when given,
    is copied, never trained in place."""
    dev = resolve_device(device)
    if d.stream_targets and all(
        t.destination_result_pkl and os.path.isfile(t.destination_result_pkl) for t in d.stream_targets
    ):
        return "skipped"

    result = transfer_learn(
        target=d.target,
        train_files=list(d.train_files),
        val_files=list(d.val_files),
        unknown_files=list(unknown_files),
        num_epochs=d.n_epochs,
        num_batches=d.n_batches,
        batch_size=d.batch_size,
        primary_lr=d.primary_lr,
        backprop_into_embedding=d.backprop_into_embedding,
        embedding_lr=d.embedding_lr,
        base_model_path=base_model_path,
        bg_datadir=bg_datadir,
        verbose=verbose,
        model=copy.deepcopy(model),
        device=dev,
    )
    if d.model_dest_dir:
        ckpt.save_model(Path(d.model_dest_dir) / result.name, result.model, metadata={
            "kind": "transfer", "target": d.target, "details": result.details,
            **ckpt.trunk_metadata(result.model.trunk),
        })
    predict_fn = result.predict_fn()
    for st in d.stream_targets:
        eval_stream_test(st, predict_fn=predict_fn, verbose=bool(verbose), device=dev)
    return result.name


class BatchRunner:
    """Persisted job list + sequential execution + resume.

    Reference pattern: pickle the full job list before starting
    (batch_transfer_learn_streaming.py:193-197), run jobs one at a time with
    elapsed-time logging (:200-206), ``resume_run`` reloads the pickle
    (:208+).
    """

    def __init__(
        self,
        batchdata_file,
        unknown_files: Sequence[str],
        base_model_path,
        bg_datadir,
        model_factory: Optional[Callable] = None,
        device="cuda",
    ):
        self.batchdata_file = Path(batchdata_file)
        self.unknown_files = list(unknown_files)
        self.base_model_path = base_model_path
        self.bg_datadir = bg_datadir
        self.model_factory = model_factory
        self.device = resolve_device(device)

    def start(self, jobs: Sequence[TLData]) -> Dict:
        if self.batchdata_file.exists():
            raise FileExistsError(f"{self.batchdata_file} already exists (use resume_run)")
        self.batchdata_file.parent.mkdir(parents=True, exist_ok=True)
        with open(self.batchdata_file, "wb") as fh:
            pickle.dump(list(jobs), fh)
        return self._run(list(jobs))

    def resume_run(self) -> Dict:
        with open(self.batchdata_file, "rb") as fh:
            jobs = pickle.load(fh)
        return self._run(jobs)

    def _run(self, jobs: List[TLData]) -> Dict:
        summary: Dict[str, List] = {"done": [], "skipped": [], "failed": []}
        total = len(jobs)
        for ix, d in enumerate(jobs):
            t0 = time.time()
            try:
                model = self.model_factory() if self.model_factory else None
                status = run_job(d, self.unknown_files, self.base_model_path, self.bg_datadir, model=model,
                                 device=self.device)
                summary["skipped" if status == "skipped" else "done"].append(d.target)
            except Exception:  # a failed job is recorded and the batch goes on
                summary["failed"].append((d.target, traceback.format_exc()))
            print(f"::::::: {ix} / {total} [{d.target}] elapsed {time.time() - t0:.1f}s", flush=True)
        return summary
