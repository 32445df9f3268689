"""ROC / EER / F1 utilities over confidence splits.

Semantic ports of the reference's threshold-sweep helpers:
- roc_sc                (roc_hyperparams.py:26-58, quick_viz.py:20)
- roc_single_target     (band_viz.py:33-93 — adds EER + F1 bookkeeping)
- roc_curve_multiclass  (band_viz.py:95-133)

All operate on the correct/incorrect confidence splits produced by
train/evaluate.py (evaluate_files_* / evaluate_fast_*) and return plain
arrays; plotting is left to the caller.

The port's own copy of ``multilingual_kws_tpu/analysis/roc.py`` (numpy only): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def roc_sc(target_results: Dict, unknown_results: Dict):
    """(tprs, fprs, threshs) for single-target splits; threshold sweep
    0..1 step 0.01 (reference roc_hyperparams.py:26-58)."""
    target_correct = np.asarray(target_results["correct"])
    target_incorrect = np.asarray(target_results["incorrect"])
    total_positives = target_correct.shape[0] + target_incorrect.shape[0]

    unknown_correct = np.asarray(unknown_results["correct"])
    unknown_incorrect = np.asarray(unknown_results["incorrect"])
    unknown_total = unknown_correct.shape[0] + unknown_incorrect.shape[0]

    threshs = np.arange(0, 1.01, 0.01)
    tprs = [
        float((target_correct > t).sum()) / max(total_positives, 1)
        for t in threshs
    ]
    fprs = [
        float((unknown_incorrect > t).sum()) / max(unknown_total, 1)
        for t in threshs
    ]
    return tprs, fprs, threshs


roc_curve_multiclass = roc_sc  # identical math (band_viz.py:95-133)


def roc_single_target(
    target_confidences: np.ndarray,
    unknown_confidences: np.ndarray,
    f1_at_threshold: Optional[float] = None,
):
    """ROC over raw per-clip target confidences + EER/F1 info.

    Reference roc_single_target (band_viz.py:33-93): inputs are the target-
    class confidence of every positive clip and every negative clip
    (evaluate_files_single_target output). Returns
    (tprs, fprs, threshs, error_rate_info) where error_rate_info =
    [|fnr-fpr|, threshold, f1, fpr, tpr] at the EER point (or at
    f1_at_threshold when given).
    """
    target = np.asarray(target_confidences)
    unknown = np.asarray(unknown_confidences)
    total_positives = max(target.shape[0], 1)
    unknown_total = max(unknown.shape[0], 1)

    tprs, fprs = [], []
    rows = []
    threshs = np.arange(0.01, 0.99, 0.01)
    for t in threshs:
        fn = float((target < t).sum())
        tp = float((target > t).sum())
        fp = float((unknown > t).sum())
        tpr = tp / total_positives
        fpr = fp / unknown_total
        fnr = fn / total_positives
        f1 = tp / max(tp + 0.5 * (fp + fn), 1e-12)
        err = abs(fnr - fpr)
        if f1_at_threshold is None or np.isclose(t, f1_at_threshold):
            rows.append([err, t, f1, fpr, tpr])
        tprs.append(tpr)
        fprs.append(fpr)

    rows = np.asarray(rows)
    if f1_at_threshold is None:
        info = rows[int(np.nanargmin(rows[:, 0]))]  # equal error rate point
    else:
        assert rows.shape[0] == 1
        info = rows[0]
    return tprs, fprs, threshs, info


def eer(target_confidences, unknown_confidences) -> Tuple[float, float]:
    """(equal_error_rate_fpr, threshold) convenience wrapper."""
    _, _, _, info = roc_single_target(target_confidences, unknown_confidences)
    return float(info[3]), float(info[1])
