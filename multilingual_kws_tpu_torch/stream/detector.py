"""Streaming detection post-processor.

Semantic port of the reference SingleTargetRecognizeCommands
(single_target_recognize_commands.py:54-207): a sliding averaging window
over per-hop softmax outputs, reliability gating (minimum count / quarter
window span), threshold + label-change + suppression logic.

Re-designed for throughput: the reference replays the full inference array
once per threshold in Python (batch_streaming_analysis.py:126-177); here one
pass over time updates all thresholds at once with vectorized numpy state —
identical per-threshold outputs.

The port's own copy of ``multilingual_kws_tpu/stream/detector.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

SILENCE = "_silence_"


@dataclass(frozen=True)
class DetectorParams:
    """Defaults from reference StreamFlags (batch_streaming_analysis.py:27-47)."""

    average_window_duration_ms: int = 100
    suppression_ms: int = 500
    minimum_count: int = 4
    target_id: int = 2


def _next_true_table(mask: np.ndarray) -> np.ndarray:
    """out[i] = smallest j >= i with mask[j], or n if none (len n+1)."""
    n = mask.shape[0]
    idxs = np.where(mask, np.arange(n, dtype=np.int64), np.int64(n))
    out = np.full(n + 1, n, dtype=np.int64)
    if n:
        out[:n] = np.minimum.accumulate(idxs[::-1])[::-1]
    return out


def detect_all_thresholds(
    inferences: np.ndarray,  # (T, num_labels) softmax outputs per hop
    times_ms: np.ndarray,  # (T,) hop start times (int ms)
    thresholds: Sequence[float],
    params: DetectorParams = DetectorParams(),
    target_name: str = "target",
) -> Dict[float, Tuple[List[List], List[List]]]:
    """Returns {threshold: (found_words, found_words_w_confidences)} where
    found_words = [[label, time_ms], ...] — exactly the reference's replay
    output (calculate_streaming_accuracy, batch_streaming_analysis.py:140-177).

    Two vectorization layers over the reference's per-threshold Python
    replay: the sliding window average is closed-form (one cumsum + one
    searchsorted giving every hop's window start), and the per-threshold
    fire/reset automaton advances by JUMPS between state changes
    (precomputed next-above/next-below tables + a searchsorted for the
    suppression horizon) instead of visiting every hop — O(detections)
    state steps, not O(hops). Semantics identical to the sequential
    replay: unreliable hops (count < minimum_count or window span <
    window/4) change no state; a target fires from the silence state with
    no elapsed gate (time-since-last is inf there,
    single_target_recognize_commands.py:187-191); from the target state a
    reset needs score strictly below threshold AND suppression_ms elapsed
    since the last fire. tests/test_detector.py pins equivalence against
    a direct port of the sequential loop on randomized inputs."""
    inferences = np.asarray(inferences)
    times_ms = np.asarray(times_ms, dtype=np.int64)
    t_steps = inferences.shape[0]
    thr_list = [float(th) for th in thresholds]
    found: Dict[float, Tuple[List[List], List[List]]] = {
        th: ([], []) for th in thr_list
    }
    if t_steps == 0:
        return found

    window = params.average_window_duration_ms
    target = params.target_id

    # window start per hop: the sequential trim advances start while
    # times[start] < now - window, i.e. start = first index with
    # times[start] >= now - window
    starts = np.searchsorted(times_ms, times_ms - window, side="left")
    counts = np.arange(t_steps, dtype=np.int64) - starts + 1
    spans = times_ms - times_ms[starts]
    reliable = (counts >= params.minimum_count) & (spans >= window / 4)

    cs = np.concatenate(
        [[0.0], np.cumsum(inferences[:, target], dtype=np.float64)]
    )
    scores = (cs[1 : t_steps + 1] - cs[starts]) / counts

    r_idx = np.nonzero(reliable)[0]
    sc = scores[r_idx]
    tms = times_ms[r_idx]
    n = r_idx.shape[0]

    for th in thr_list:
        next_above = _next_true_table(sc > th)
        next_below = _next_true_table(sc < th)
        fw, fwc = found[th]
        pos = 0
        while True:
            # silence state: the first above-threshold reliable hop fires
            pos = next_above[pos]
            if pos >= n:
                break
            now = int(tms[pos])
            fw.append([target_name, now])
            fwc.append([target_name, now, float(sc[pos])])
            # target state: reset at the first hop strictly below the
            # threshold AND past the suppression horizon
            horizon = int(
                np.searchsorted(tms, now + params.suppression_ms, side="right")
            )
            pos = next_below[max(pos + 1, horizon)]
            if pos >= n:
                break
            pos += 1

    return found


class SingleTargetRecognizeCommands:
    """Streaming (online) single-threshold detector with the exact reference
    interface — for incremental/live use. Same math as detect_all_thresholds.
    """

    def __init__(
        self,
        labels: Sequence[str],
        average_window_duration_ms: int,
        detection_threshold: float,
        suppression_ms: int,
        minimum_count: int,
        target_id: int = 2,
    ):
        self._labels = list(labels)
        self._window = average_window_duration_ms
        self._threshold = detection_threshold
        self._suppression = suppression_ms
        self._minimum_count = minimum_count
        self._target_id = target_id
        self._times: List[int] = []
        self._scores: List[np.ndarray] = []
        self._prev_top = SILENCE
        self._prev_time = -np.inf

    def process_latest_result(self, latest: np.ndarray, now_ms: int):
        """Returns (found_command, score, is_new_command)."""
        if latest.shape[0] != len(self._labels):
            raise ValueError(
                f"results size {latest.shape[0]} != label count {len(self._labels)}"
            )
        if self._times and now_ms < self._times[0]:
            raise ValueError("results must be fed in increasing time order")
        self._times.append(int(now_ms))
        self._scores.append(np.asarray(latest, dtype=np.float64))
        time_limit = now_ms - self._window
        while time_limit > self._times[0]:
            self._times.pop(0)
            self._scores.pop(0)

        count = len(self._times)
        span = now_ms - self._times[0]
        if count < self._minimum_count or span < self._window / 4:
            return self._prev_top, 0.0, False

        score = float(np.mean([s[self._target_id] for s in self._scores]))
        label = self._labels[self._target_id] if score > self._threshold else SILENCE
        since = (
            np.inf
            if (self._prev_top == SILENCE or self._prev_time == -np.inf)
            else now_ms - self._prev_time
        )
        is_new = False
        if score > self._threshold and label != self._prev_top and since > self._suppression:
            self._prev_top = label
            self._prev_time = now_ms
            is_new = True
        elif score < self._threshold and label == SILENCE and since > self._suppression:
            self._prev_top = label
            self._prev_time = now_ms
            is_new = True
        return label, score, is_new
