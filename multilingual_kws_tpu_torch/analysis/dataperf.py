"""DataPerf-style selection-algorithm test harness.

Equivalent of reference notebooks/dataperf_test_harness.py: benchmark a
*training-sample selection algorithm* — given a pool of candidate clips for
a keyword, pick the N best for few-shot training — by repeatedly training a
cheap eval classifier on the selected embedding vectors and scoring held-out
target + nontarget clips over many random splits.

The embedding vectors come from the 192-d KWS embedding (make_embedding_fn,
analysis/distance_filtering.py) or any other extractor. The eval model is sklearn LogisticRegression as
in the reference notebooks.

The port's own copy of ``multilingual_kws_tpu/analysis/dataperf.py`` (numpy only): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class TestParams:
    """Reference TestParams (dataperf_test_harness.py:29-45)."""

    minimum_total_samples: int = 500
    language_isocode: str = "en"
    num_targets: int = 5
    num_experiments: int = 200
    num_splits_per_experiment: int = 10
    num_target_samples: int = 100
    minimum_samples_for_nontarget_words: int = 200
    num_nontarget_training_words: int = 100
    num_nontarget_eval_words: int = 100
    SEED_EXPERIMENT_GENERATION: int = 0
    SEED_NONTARGET_SELECTION: int = 0
    SEED_SPLITTER: int = 0


def candidate_words(wordcounts: Dict[str, int], minimum_total_samples: int) -> List[str]:
    """Words with enough samples to be selection targets
    (dataperf_test_harness.py:56-60)."""
    return sorted(w for w, c in wordcounts.items() if c > minimum_total_samples)


def evaluate_selection(
    selected_vectors: np.ndarray,
    selected_labels: np.ndarray,
    eval_vectors: np.ndarray,
    eval_labels: np.ndarray,
    num_splits: int = 10,
    seed: int = 0,
    model_factory: Optional[Callable] = None,
) -> Dict:
    """Train the cheap eval model on the selected samples, score held-out
    clips; repeated over shuffled fits for variance. Returns accuracy stats.

    labels: 1 = target, 0 = nontarget (binary, as in the reference harness).
    """
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(seed)
    accs, target_recalls, nontarget_recalls = [], [], []
    for _ in range(num_splits):
        order = rng.permutation(len(selected_labels))
        model = (model_factory or (lambda: LogisticRegression(max_iter=1000)))()
        model.fit(selected_vectors[order], selected_labels[order])
        pred = model.predict(eval_vectors)
        accs.append(float((pred == eval_labels).mean()))
        tmask = eval_labels == 1
        target_recalls.append(float((pred[tmask] == 1).mean()))
        nontarget_recalls.append(float((pred[~tmask] == 0).mean()))
    return dict(
        accuracy_mean=float(np.mean(accs)),
        accuracy_std=float(np.std(accs)),
        target_recall_mean=float(np.mean(target_recalls)),
        nontarget_recall_mean=float(np.mean(nontarget_recalls)),
        num_splits=num_splits,
    )


def run_harness(
    selection_fn: Callable[[np.ndarray, int], np.ndarray],
    pool_vectors: np.ndarray,
    pool_labels: np.ndarray,
    eval_vectors: np.ndarray,
    eval_labels: np.ndarray,
    num_to_select: int,
    params: TestParams = TestParams(),
) -> Dict:
    """Score `selection_fn` against a uniform-random selection baseline.

    selection_fn(pool_vectors, num_to_select) -> indices into the pool.
    Returns both scores plus the margin (positive = selection beats random).
    """
    idx = np.asarray(selection_fn(pool_vectors, num_to_select))
    assert idx.ndim == 1 and len(idx) <= num_to_select
    selected = evaluate_selection(
        pool_vectors[idx], pool_labels[idx], eval_vectors, eval_labels,
        num_splits=params.num_splits_per_experiment, seed=params.SEED_SPLITTER,
    )

    rng = np.random.default_rng(params.SEED_EXPERIMENT_GENERATION)
    ridx = rng.choice(len(pool_labels), num_to_select, replace=False)
    random_baseline = evaluate_selection(
        pool_vectors[ridx], pool_labels[ridx], eval_vectors, eval_labels,
        num_splits=params.num_splits_per_experiment, seed=params.SEED_SPLITTER,
    )
    return dict(
        selection=selected,
        random_baseline=random_baseline,
        margin=selected["accuracy_mean"] - random_baseline["accuracy_mean"],
    )
