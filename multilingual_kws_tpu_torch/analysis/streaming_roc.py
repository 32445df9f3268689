"""Streaming-detection ROC analysis: TPR vs false-accepts/hour.

Equivalent of the reference's Luganda case-study evaluation
(luganda/luganda_eval.py:84-188): load streaming result pickles (the
{target: [(flags, {thresh: (found_words, ...)})]} contract from
stream/engine.py), score every threshold with tpr_fpr, and emit
TPR-vs-FA/h curves with the nominal 50 FA/h operating cutoff
(luganda_eval.py:165-167). Data only — plotting stays with the caller.

The port's own copy of ``multilingual_kws_tpu/analysis/streaming_roc.py`` (numpy only): the port
imports nothing of the JAX package. A result pickle holds the ``StreamFlags``
of the package that wrote it, so unpickling one imports that package's
``stream.engine``: the port reads the JAX package's pickles where the JAX
package is installed, and the JAX package reads the port's.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..stream.tprfpr import tpr_fpr

NOMINAL_FA_PER_HOUR_CUTOFF = 50.0  # reference luganda_eval.py:165-167


def streaming_roc(
    results: Dict,
    keyword: str,
    gt_target_times_ms: Sequence[float],
    duration_s: float,
    num_nontarget_words: Optional[int] = None,
    min_threshold: float = 0.3,
) -> Dict:
    """One keyword's streaming results -> ROC arrays.

    results: eval_stream_test output ({keyword: [(flags, {thresh: (found, _)})]}).
    Returns dict(thresholds, tprs, fa_per_hour, analyses).
    """
    thresholds: List[float] = []
    tprs: List[float] = []
    fahs: List[float] = []
    analyses: List[Dict] = []
    for flags, per_thresh in results[keyword]:
        for thresh, (found_words, _) in sorted(per_thresh.items()):
            if thresh < min_threshold:
                continue
            a = tpr_fpr(
                keyword,
                thresh,
                found_words,
                gt_target_times_ms,
                duration_s=duration_s,
                time_tolerance_ms=flags.time_tolerance_ms,
                num_nontarget_words=num_nontarget_words,
            )
            thresholds.append(float(thresh))
            tprs.append(a["tpr"])
            fahs.append(a["false_accepts_per_hour"])
            analyses.append(a)
    return dict(
        keyword=keyword,
        thresholds=thresholds,
        tprs=tprs,
        fa_per_hour=fahs,
        analyses=analyses,
    )


def operating_point(
    roc: Dict, max_fa_per_hour: float = NOMINAL_FA_PER_HOUR_CUTOFF
) -> Optional[Dict]:
    """Best TPR subject to the FA/h budget; None when no threshold qualifies."""
    best = None
    for t, tpr, fah in zip(roc["thresholds"], roc["tprs"], roc["fa_per_hour"]):
        if fah <= max_fa_per_hour and (best is None or tpr > best["tpr"]):
            best = dict(threshold=t, tpr=tpr, fa_per_hour=fah)
    return best


def frr_fa_view(roc: Dict) -> Dict:
    """FRR (false-rejections per instance) vs false-accepts/second — the
    streaming_FRR_FAR_curve view (test_streaming_accuracy.py:659-760,
    multi_streaming_FRR_FAR_curve :216-350)."""
    return dict(
        keyword=roc["keyword"],
        thresholds=roc["thresholds"],
        false_rejection_rates=[
            a["false_rejections_per_instance"] for a in roc["analyses"]
        ],
        false_accepts_per_sec=[f / 3600.0 for f in roc["fa_per_hour"]],
    )


def load_sweep_rocs(
    sweep_dir,
    eval_data: Dict[str, Dict],
    result_name: str = "result.pkl",
    min_threshold: float = 0.3,
) -> List[Dict]:
    """Scan a sweep directory tree for result pickles (the reference's
    hpsweep/exp/trial layout, luganda_eval.py:84-96) and build ROC data.

    eval_data: {keyword: {"times": [...ms], "duration_s": s, "num_nt": n}}.
    """
    out = []
    sweep_dir = Path(sweep_dir)
    for rp in sorted(sweep_dir.rglob(result_name)):
        with open(rp, "rb") as fh:
            results = pickle.load(fh)
        for keyword in results:
            ed = eval_data[keyword]
            roc = streaming_roc(
                results,
                keyword,
                ed["times"],
                ed["duration_s"],
                num_nontarget_words=ed.get("num_nt"),
                min_threshold=min_threshold,
            )
            roc["result_path"] = str(rp)
            out.append(roc)
    return out
