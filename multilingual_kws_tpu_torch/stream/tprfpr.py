"""TPR / false-accepts-per-hour metrics and detection tagging.

Semantic port of reference embedding/tpr_fpr.py: get_groundtruth tags each
detection tp/fp/fn for the visualizer (:1-61, default tolerance 1500 ms);
tpr_fpr computes TPR, false-rejections-per-instance, false-accepts/hour and
optional FPR (:63-138).

The port's own copy of ``multilingual_kws_tpu/stream/tprfpr.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def get_groundtruth(
    found_words: Sequence[Sequence],
    targets: Sequence[str],
    groundtruth: Sequence[Tuple[str, float]],
    time_tolerance_ms: float = 1500,
) -> List[Dict]:
    """Tag detections vs groundtruth -> visualizer dicts (tpr_fpr.py:1-61).

    found_words: [[keyword, time_ms, confidence], ...] (sorted by time);
    groundtruth: [(keyword, time_ms), ...].

    Unlike the reference (which returns inside the first loop iteration,
    tpr_fpr.py:60, so only the first target is ever tagged), every target
    is tagged and the results concatenated — the mandate is capability
    match, not bug match. Times are sorted per target so the early-break
    scan below stays correct regardless of input order.
    """
    detections: List[Dict] = []
    for target in targets:
        gt_times = sorted(t for k, t in groundtruth if k == target)
        found_target = sorted(
            (f for f in found_words if f[0] == target), key=lambda f: f[1]
        )

        for time in gt_times:
            latest = time + time_tolerance_ms
            earliest = time - time_tolerance_ms
            match = False
            for _, found_time, _ in found_target:
                if found_time > latest:
                    break
                if found_time < earliest:
                    continue
                match = True
            if not match:
                detections.append(dict(keyword=target, time_ms=time, groundtruth="fn"))

        for _, time, confidence in found_target:
            latest = time + time_tolerance_ms
            earliest = time - time_tolerance_ms
            match = False
            for gt_time in gt_times:
                if gt_time > latest:
                    break
                if gt_time < earliest:
                    continue
                match = True
            detections.append(
                dict(
                    keyword=target,
                    time_ms=time,
                    confidence=confidence,
                    groundtruth="tp" if match else "fp",
                )
            )
    return detections


def tpr_fpr(
    keyword: str,
    thresh: float,
    found_words: Sequence[Sequence],
    gt_target_times_ms: Sequence[float],
    duration_s: float,
    time_tolerance_ms: float,
    num_nontarget_words: Optional[int] = None,
) -> Dict:
    """TPR / FR-per-instance / false-accepts-per-hour (tpr_fpr.py:63-138)."""
    found_target_times = [t for f, t in found_words if f == keyword]

    false_negatives = 0
    for time_ms in gt_target_times_ms:
        latest = time_ms + time_tolerance_ms
        earliest = time_ms - time_tolerance_ms
        match = False
        for found_time in found_target_times:
            if found_time > latest:
                break
            if found_time < earliest:
                continue
            match = True
        if not match:
            false_negatives += 1

    false_positives = 0
    true_positives = 0
    for word, time in found_words:
        if word != keyword:
            continue
        latest = time + time_tolerance_ms
        earliest = time - time_tolerance_ms
        match = False
        for gt_time in gt_target_times_ms:
            if gt_time > latest:
                break
            if gt_time < earliest:
                continue
            match = True
        if match:
            true_positives += 1
        else:
            false_positives += 1

    if true_positives > len(gt_target_times_ms):
        # multiple detections above suppression window mapped to one GT
        true_positives = len(gt_target_times_ms)

    tpr = true_positives / len(gt_target_times_ms)
    frpi = false_negatives / len(gt_target_times_ms)
    false_positives = len(found_target_times) - true_positives
    fah = false_positives / duration_s * 3600

    result = dict(
        keyword=keyword,
        tpr=tpr,
        thresh=thresh,
        true_positives=true_positives,
        false_positives=false_positives,
        false_negatives=false_negatives,
        false_rejections_per_instance=frpi,
        false_accepts_per_hour=fah,
        groundtruth_positives=len(gt_target_times_ms),
    )
    if num_nontarget_words is not None:
        result["fpr"] = false_positives / num_nontarget_words
    return result
