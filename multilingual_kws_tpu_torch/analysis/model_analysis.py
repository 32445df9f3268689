"""Fine-tuned-model analysis: per-category confidence splits + ROC.

Equivalent of reference embedding/transfer_learning_analysis.py:36-222
(`analyze_model` + `calc_roc`): evaluate a few-shot model against

- its target keyword clips (positives),
- OOV words never seen in training,
- the words used to train the _unknown_ category,
- the original embedding-training words (all negatives),

splitting prediction confidences into correct/incorrect per category, then
sweep thresholds 0..1 for TPR/FPR. Plotting stays out of the core (the
reference mixes matplotlib/plotly into the analysis module); `roc_curve`
returns plain arrays any plotting frontend can consume.

Counterpart of ``multilingual_kws_tpu/analysis/model_analysis.py``: the
clips are featurized on ``device`` (the port's ``train/evaluate.py``; on a
card the ``clip_features`` kernel) and the splits come back as floats.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..train.evaluate import evaluate_fast_multiclass

UNKNOWN_WORD_INDEX = 1  # label ordering contract (settings.py)


def analyze_model(
    predict_fn: Callable[[np.ndarray], np.ndarray],
    model_commands: Sequence[str],
    val_acc: float,
    data_dir,
    unknown_training_words: Sequence[str],
    oov_words: Sequence[str],
    embedding_commands: Sequence[str],
    num_samples_command: int = 1500,
    n_words_oov_unknown: int = 50,
    n_examples_oov_unknown: int = 200,
    seed: Optional[int] = None,
    device="cuda",
) -> Dict:
    """Reference analyze_model (transfer_learning_analysis.py:36-113).

    predict_fn: (B, 49, 40, 1) float32 tensor on ``device`` -> (B, 3)
    softmax (e.g. FinetuneResult.predict_fn()). data_dir contains
    <word>/<clip>.wav.
    """
    assert len(model_commands) == 1, "single-target analysis (reference parity)"
    rng = np.random.default_rng(seed)
    label_id = 2  # target after [_silence_, _unknown_]

    target_results = evaluate_fast_multiclass(
        model_commands, label_id, data_dir, num_samples_command, predict_fn,
        rng=rng, device=device,
    )

    oov_testing = sorted(set(oov_words).difference(set(model_commands)))
    ots = _sample(oov_testing, n_words_oov_unknown, rng)
    oov_results = evaluate_fast_multiclass(
        ots, UNKNOWN_WORD_INDEX, data_dir, n_examples_oov_unknown, predict_fn,
        rng=rng, device=device,
    )

    uts = _sample(list(unknown_training_words), n_words_oov_unknown, rng)
    unknown_training_results = evaluate_fast_multiclass(
        uts, UNKNOWN_WORD_INDEX, data_dir, n_examples_oov_unknown, predict_fn,
        rng=rng, device=device,
    )

    uws = _sample(list(embedding_commands), n_words_oov_unknown, rng)
    original_embedding_results = evaluate_fast_multiclass(
        uws, UNKNOWN_WORD_INDEX, data_dir, n_examples_oov_unknown, predict_fn,
        rng=rng, device=device,
    )

    return {
        "oov_testing": set(oov_testing),
        "unknown_training_words": uts,
        "original_embedding_words": uws,
        "oov": oov_results,
        "original_embedding": original_embedding_results,
        "target_keywords": target_results,
        "unknown_training": unknown_training_results,
        "words": list(model_commands),
        "val_acc": val_acc,
    }


def _sample(items: List, n: int, rng) -> List:
    if len(items) > n:
        return list(rng.choice(items, n, replace=False))
    return list(items)


def calc_roc(res: Dict):
    """Threshold sweep 0..1 step 0.01 -> (tprs, fprs).

    Reference calc_roc (transfer_learning_analysis.py:181-222): positives are
    target clips classified target; false positives are any negative-category
    clip (oov / unknown-train / embedding words) classified target — i.e. the
    "incorrect" confidence split of each negative category.
    """
    target_correct = np.asarray(res["target_keywords"]["correct"])
    target_incorrect = np.asarray(res["target_keywords"]["incorrect"])
    total_positives = target_correct.shape[0] + target_incorrect.shape[0]

    negatives_total = 0
    false_positive_confs = []
    for k in ("oov", "unknown_training", "original_embedding"):
        negatives_total += len(res[k]["correct"]) + len(res[k]["incorrect"])
        false_positive_confs.append(np.asarray(res[k]["incorrect"]))
    false_positives = (
        np.concatenate(false_positive_confs)
        if false_positive_confs
        else np.zeros(0)
    )

    threshs = np.arange(0, 1.01, 0.01)
    tprs = [
        float((target_correct > t).sum()) / max(total_positives, 1)
        for t in threshs
    ]
    fprs = [
        float((false_positives > t).sum()) / max(negatives_total, 1)
        for t in threshs
    ]
    return tprs, fprs


def roc_curve(results: Sequence[Dict]) -> List[Dict]:
    """Plot-ready ROC data for a batch of analyze_model results (replaces
    make_roc/make_roc_plotly figure builders, :227-262)."""
    out = []
    for res in results:
        tprs, fprs = calc_roc(res)
        out.append(
            {
                "title": ", ".join(res["words"]) + f" (val acc {res['val_acc']})",
                "tprs": tprs,
                "fprs": fprs,
                "thresholds": list(np.arange(0, 1.01, 0.01)),
            }
        )
    return out


def auc(tprs: Sequence[float], fprs: Sequence[float]) -> float:
    """Area under the (fpr, tpr) curve via the trapezoid rule."""
    order = np.argsort(fprs)
    f = np.asarray(fprs)[order]
    t = np.asarray(tprs)[order]
    return float(np.trapezoid(t, f))
