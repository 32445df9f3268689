"""Streaming accuracy statistics.

Semantic port of the reference StreamingAccuracyStats
(embedding/accuracy_utils.py:25-251): greedy time-tolerance matching of
found words against ground truth, per-label matched/wrong breakdowns, FP and
FN counting, and the same printable/dict outputs.

The port's own copy of ``multilingual_kws_tpu/stream/stats.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..settings import SILENCE_LABEL, UNKNOWN_WORD_LABEL


def read_ground_truth_file(file_name) -> List[Tuple[str, int]]:
    """CSV lines "label, time_ms" -> sorted [(label, ms)] (accuracy_utils.py:62-72)."""
    out = []
    with open(file_name) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) != 2:
                continue
            out.append((parts[0], round(float(parts[1]))))
    return sorted(out, key=lambda item: item[1])


class StreamingAccuracyStats:
    def __init__(self, target_keyword: str):
        self.target_keyword = target_keyword
        self._gt_occurrence: List[Tuple[str, int]] = []
        self._how_many_gt = 0
        self._how_many_gt_matched = 0
        self._how_many_fp = 0
        self._how_many_c = 0
        self._how_many_w = 0
        self._how_many_fn = 0
        self._which_matched: Dict[str, int] = {}
        self._which_wrong: Dict[str, int] = {}
        self._how_many_gt_target = 0
        self._how_many_gt_unknown_or_silence = 0
        self._previous_c = 0
        self._previous_w = 0
        self._previous_fp = 0

    def read_ground_truth_file(self, file_name):
        self._gt_occurrence = read_ground_truth_file(file_name)

    def set_ground_truth(self, occurrences: Sequence[Tuple[str, int]]):
        self._gt_occurrence = sorted(occurrences, key=lambda o: o[1])

    def delta(self) -> str:
        """Recognition state vs previous call (accuracy_utils.py:74-91)."""
        fp_d = self._how_many_fp - self._previous_fp
        w_d = self._how_many_w - self._previous_w
        c_d = self._how_many_c - self._previous_c
        if fp_d == 1:
            state = "(False Positive)"
        elif c_d == 1:
            state = "(Correct)"
        elif w_d == 1:
            state = "(Wrong)"
        else:
            raise ValueError("Unexpected state in statistics")
        self._previous_c = self._how_many_c
        self._previous_w = self._how_many_w
        self._previous_fp = self._how_many_fp
        return state

    def calculate_accuracy_stats(
        self,
        found_words: Sequence[Sequence],
        up_to_time_ms: int,
        time_tolerance_ms: int,
    ):
        """Greedy matching up to a time horizon (accuracy_utils.py:93-203).

        found_words: [[label, time_ms], ...]; up_to_time_ms == -1 means all.

        The reference's loops (every found word scans the ground truth, every
        ground-truth entry scans the found words) as searches in sorted
        times, with the same counters:
        - a found word matches the first entry in time order with
          earliest <= t <= latest and t <= latest_possible: the first entry
          with t >= earliest, if it is in range;
        - it is correct when the labels agree and no earlier found word (in
          list order) matched that entry's time; an earlier match is keyed on
          the time, and every word matching time t matched its first entry;
        - an entry with t < latest_possible is missed when no found time
          lies strictly inside (t - tol, t + tol): time - tol and
          time + tol both rise with the sorted found times, so the words
          with time - tol < t and those with time + tol <= t are two
          prefixes, and some word lies inside exactly when the first
          prefix is longer.
        """
        tol = time_tolerance_ms
        latest_possible = np.inf if up_to_time_ms == -1 else up_to_time_ms + tol
        gt_labels = [label for label, _ in self._gt_occurrence]
        gt_times = np.array([t for _, t in self._gt_occurrence])
        n_gt = gt_times.shape[0]

        # the entries up to the horizon: a prefix of the sorted times
        self._how_many_gt = int(np.searchsorted(gt_times, latest_possible, side="right"))
        self._how_many_gt_target = 0
        self._how_many_gt_unknown_or_silence = 0
        for label in gt_labels[: self._how_many_gt]:
            if label in (SILENCE_LABEL, UNKNOWN_WORD_LABEL):
                self._how_many_gt_unknown_or_silence += 1
            elif label == self.target_keyword:
                self._how_many_gt_target += 1

        words = [SILENCE_LABEL, UNKNOWN_WORD_LABEL, self.target_keyword]
        self._which_matched = {w: 0 for w in words}
        self._which_wrong = {w: 0 for w in words}

        found_labels = [fw[0] for fw in found_words]
        found_times = np.array([fw[1] for fw in found_words])
        first = np.searchsorted(gt_times, found_times - tol, side="left")
        matched = first < n_gt
        if n_gt:
            candidate = gt_times[np.minimum(first, n_gt - 1)]
            matched &= (candidate <= found_times + tol) & (candidate <= latest_possible)
        which = np.flatnonzero(matched)
        entry = first[which]
        # the first found word to match each entry (np.unique's return_index
        # is the first occurrence)
        new_entry = np.zeros(which.shape[0], dtype=bool)
        new_entry[np.unique(entry, return_index=True)[1]] = True
        self._how_many_gt_matched = int(np.count_nonzero(new_entry))

        self._how_many_fp = len(found_labels) - which.shape[0]
        self._how_many_c = 0
        self._how_many_w = 0
        for f, e, new in zip(which.tolist(), entry.tolist(), new_entry.tolist()):
            found_label, gt_label = found_labels[f], gt_labels[e]
            if new and gt_label == found_label:
                self._how_many_c += 1
                self._which_matched[found_label] += 1
            else:
                self._how_many_w += 1
                if gt_label in (UNKNOWN_WORD_LABEL, SILENCE_LABEL) and found_label == self.target_keyword:
                    self._which_wrong[gt_label] += 1

        # false negatives: entries before the horizon with no found word
        # strictly within the tolerance
        ordered = np.sort(found_times)
        t = gt_times[: np.searchsorted(gt_times, latest_possible, side="left")]
        opened = np.searchsorted(ordered - tol, t, side="left")  # words with time - tol < t
        closed = np.searchsorted(ordered + tol, t, side="right")  # words with time + tol <= t
        self._how_many_fn = int(np.count_nonzero(opened <= closed))

    def print_accuracy_stats(self, do_print: bool = True):
        """Human-readable info + stats dict (accuracy_utils.py:207-251)."""
        if self._how_many_gt == 0:
            info = "No ground truth yet, {}false positives".format(self._how_many_fp)
            if do_print:
                print(info)
            return info, {}
        any_match = self._how_many_gt_matched / self._how_many_gt * 100
        correct = self._how_many_c / self._how_many_gt * 100
        wrong = self._how_many_w / self._how_many_gt * 100
        fp = self._how_many_fp / self._how_many_gt * 100
        fn = self._how_many_fn / self._how_many_gt * 100
        info = (
            "{:.1f}% matched, {:.1f}% correct, {:.1f}% wrong, "
            "{:.1f}% false positive, {:.1f}% false negative, "
            "{:.1f} howmanyfp, {:.1f} howmanyfn".format(
                any_match, correct, wrong, fp, fn,
                self._how_many_fp, self._how_many_fn,
            )
        )
        if do_print:
            print(info)
        stat = {
            "correct_match_percentage": correct,
            "wrong_match_percentage": wrong,
            "howmanyfp": self._how_many_fp,
            "howmanyfn": self._how_many_fn,
            "wrong": dict(self._which_wrong),
            "matched": dict(self._which_matched),
            "num_groundtruth_target": self._how_many_gt_target,
            "num_groundtruth_unknown_or_silence": self._how_many_gt_unknown_or_silence,
        }
        return info, stat
