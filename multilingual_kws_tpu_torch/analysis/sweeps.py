"""Hyperparameter and utterance-count sweeps over few-shot fine-tuning.

Counterpart of ``multilingual_kws_tpu/analysis/sweeps.py``, the reference's
paper-scale sweep harnesses:

- utterance_sweep.py:105-183 (RunTransferLearning jobs, per-run pickles
  ``hpsweep_{ix:03d}.pkl`` holding target/unknown confidence splits and
  details);
- roc_hyperparams.py (the epochs x batches x batch-size grid over
  SamplePoint);
- luganda/luganda_train.py:35-102 (train -> stream sweeps, which
  analysis/batch_jobs.py covers).

In-process and resumable by the per-run result pickles. A point trains and
evaluates on ``device``, saves its model through the port's checkpoints, and
pickles numpy and plain Python only (no tensors), so the JAX package's
``load_sweep_results`` reads the port's pickles and the port's reads the
JAX package's.
"""

from __future__ import annotations

import copy
import itertools
import pickle
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .. import resolve_device
from ..train import checkpoints as ckpt
from ..train.evaluate import evaluate_fast_multiclass
from ..train.finetune import transfer_learn
from .roc import roc_sc


@dataclass(frozen=True)
class SweepPoint:
    """One grid point (reference SamplePoint, roc_hyperparams.py:84-88, and
    the RunTransferLearning fields, utterance_sweep.py:105-124)."""

    ix: int
    trial: int
    target: str
    train_files: List[str]
    val_files: List[str]
    unknown_files: List[str]  # unknown utterances for training
    unknown_sample: List[str]  # unknown WORDS sampled for evaluation
    num_epochs: int
    num_batches: int
    batch_size: int
    target_set: int = 0
    primary_lr: float = 1e-3


def run_sweep_point(
    sp: SweepPoint,
    dest_dir,
    data_dir,
    base_model_path=None,
    bg_datadir=None,
    model=None,
    n_target_eval: int = 1500,
    n_unknown_eval: int = 600,
    verbose: int = 0,
    device="cuda",
) -> Optional[Dict]:
    """Train one point, evaluate target against unknown words, pickle the
    results as results/hpsweep_{ix:03d}.pkl (reference run_transfer_learning,
    utterance_sweep.py:126-183). Returns None without training when the
    pickle exists (resume). ``model``, when given, is copied, never trained
    in place."""
    dev = resolve_device(device)
    dest_dir = Path(dest_dir)
    result_file = dest_dir / "results" / f"hpsweep_{sp.ix:03d}.pkl"
    if result_file.exists():
        return None
    result = transfer_learn(
        target=sp.target,
        train_files=list(sp.train_files),
        val_files=list(sp.val_files),
        unknown_files=list(sp.unknown_files),
        num_epochs=sp.num_epochs,
        num_batches=sp.num_batches,
        batch_size=sp.batch_size,
        primary_lr=sp.primary_lr,
        backprop_into_embedding=False,
        embedding_lr=0,
        base_model_path=base_model_path,
        bg_datadir=bg_datadir,
        verbose=verbose,
        model=copy.deepcopy(model),
        device=dev,
    )

    save_dest = dest_dir / "models" / f"targetset{sp.target_set}_trial{sp.trial}__{result.name}"
    ckpt.save_model(save_dest, result.model, metadata={
        "kind": "transfer", "target": sp.target, "details": result.details,
        **ckpt.trunk_metadata(result.model.trunk),
    })

    predict_fn = result.predict_fn()
    target_results = evaluate_fast_multiclass([sp.target], 2, data_dir, n_target_eval, predict_fn, device=dev)
    unknown_results = evaluate_fast_multiclass(sp.unknown_sample, 1, data_dir, n_unknown_eval, predict_fn, device=dev)
    out = dict(
        target_results=target_results,
        unknown_results=unknown_results,
        details=result.details,
        sweep_point=asdict(sp),
    )
    result_file.parent.mkdir(parents=True, exist_ok=True)
    with open(result_file, "wb") as fh:
        pickle.dump(out, fh)
    return out


def grid(
    targets_with_files: Dict[str, Dict[str, List[str]]],
    epochs: Sequence[int],
    batches: Sequence[int],
    batch_sizes: Sequence[int],
    trials: int = 1,
    **common,
) -> List[SweepPoint]:
    """The epochs x batches x batch-size x trials grid (reference
    roc_hyperparams SamplePoint loop)."""
    points = []
    ix = 0
    for target, files in targets_with_files.items():
        for ne, nb, bs, trial in itertools.product(epochs, batches, batch_sizes, range(trials)):
            points.append(
                SweepPoint(
                    ix=ix, trial=trial, target=target,
                    num_epochs=ne, num_batches=nb, batch_size=bs,
                    train_files=files["train"], val_files=files["val"],
                    unknown_files=files["unknown"],
                    unknown_sample=files.get("unknown_sample", []),
                    **common,
                )
            )
            ix += 1
    return points


def load_sweep_results(dest_dir) -> List[Dict]:
    """Load every hpsweep pickle and attach (tprs, fprs, threshs) from
    roc_sc (reference roc_hyperparams.py:160-180)."""
    out = []
    results_dir = Path(dest_dir) / "results"
    for p in sorted(results_dir.glob("hpsweep_*.pkl")):
        with open(p, "rb") as fh:
            rd = pickle.load(fh)
        tprs, fprs, threshs = roc_sc(rd["target_results"], rd["unknown_results"])
        rd["tprs"], rd["fprs"], rd["threshs"] = tprs, fprs, threshs
        out.append(rd)
    return out
