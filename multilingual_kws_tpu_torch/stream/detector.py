"""Streaming detection post-processor.

Semantic port of the reference SingleTargetRecognizeCommands
(single_target_recognize_commands.py:54-207): a sliding averaging window
over per-hop softmax outputs, reliability gating (minimum count / quarter
window span), threshold + label-change + suppression logic.

Re-designed for throughput: the reference replays the full inference array
once per threshold in Python (batch_streaming_analysis.py:126-177); here the
window average and the runs above and below each threshold are array passes
shared by all thresholds, each run's successor fire is a sorted search, and
each threshold walks only its chain of fires: identical per-threshold
outputs.

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


def _run_starts(masks: np.ndarray) -> List[np.ndarray]:
    """Row k's run starts: the sorted j with masks[k, j] and not
    masks[k, j - 1] (j = 0 where masks[k, 0]), one array a row."""
    rows, n = masks.shape
    starts = np.empty_like(masks)
    starts[:, :1] = masks[:, :1]
    np.greater(masks[:, 1:], masks[:, :-1], out=starts[:, 1:])
    # one flat search: np.nonzero of a 2-D mask costs ten times as much
    row, j = np.divmod(np.flatnonzero(starts), n)
    return np.split(j, np.searchsorted(row, np.arange(1, rows)))


class Detections(dict):
    """``{threshold: (found_words, found_words_w_confidences)}``, a plain
    dict of mutable lists, with ``hops``: the reliable hops the detector
    stepped through (the engine counts them on its ``engine.detect`` span)."""

    hops = 0


def detect_all_thresholds(
    inferences: np.ndarray,  # (T, num_labels) softmax outputs per hop
    times_ms: np.ndarray,  # (T,) hop start times (int ms)
    thresholds: Sequence[float],
    params: DetectorParams = DetectorParams(),
    target_name: str = "target",
) -> Dict[float, Tuple[List[List], List[List]]]:
    """Returns {threshold: (found_words, found_words_w_confidences)} where
    found_words = [[label, time_ms], ...] (int ms) and the other
    [[label, time_ms, score], ...] (float score), Python lists of Python
    numbers: exactly the reference's replay output
    (calculate_streaming_accuracy, batch_streaming_analysis.py:140-177).
    The dict is a ``Detections``, which also carries the reliable hop count.

    Vectorized over the reference's per-threshold Python replay: the
    sliding window average is closed-form (one cumsum + one searchsorted
    giving every hop's window start); the runs above and below every
    threshold come from one 2-D pass; each run above's successor fire (its
    suppression horizon, the reset after it, the next run above) is three
    searchsorted over that threshold's run starts; and the Python loop
    only follows the chain of fires through those successors, so it is
    O(detections) in Python ints, not O(hops). Semantics identical to the
    sequential replay: unreliable hops (count < minimum_count or window
    span < window/4) change no state; a target fires from the silence
    state with no elapsed gate (time-since-last is inf there,
    single_target_recognize_commands.py:187-191); from the target state a
    reset needs score strictly below threshold AND suppression_ms elapsed
    since the last fire. tests/test_torch_stream_detect.py holds it ``==``
    to one ``SingleTargetRecognizeCommands`` replay a threshold."""
    inferences = np.asarray(inferences)
    times_ms = np.asarray(times_ms, dtype=np.int64)
    t_steps = inferences.shape[0]
    thr_list = [float(th) for th in thresholds]
    found = Detections((th, ([], [])) for th in thr_list)
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

    r_idx = np.flatnonzero(reliable)
    sc = scores[r_idx]
    tms = times_ms[r_idx]
    n = r_idx.shape[0]
    found.hops = n
    if n == 0 or not thr_list:
        return found

    ths = np.asarray(thr_list, dtype=np.float64)[:, None]
    above = sc > ths
    # one column past the last hop, below nothing: a reset from there is none
    below = np.zeros((len(thr_list), n + 1), dtype=bool)
    np.less(sc, ths, out=below[:, :n])

    for k, (th, a, b) in enumerate(zip(thr_list, _run_starts(above), _run_starts(below))):
        # Every fire is the start of a run of above-threshold hops: the
        # first hop above after a reset (which is below) or, from the
        # silence state at the start, the first hop above. For each run
        # start a (a fire there or not), the next fire:
        # - the state may reset from rf on: the first hop past a and past
        #   the suppression horizon (time strictly later than now +
        #   suppression_ms);
        rf = np.maximum(np.searchsorted(tms, tms[a] + params.suppression_ms, side="right"), a + 1)
        # - it resets at the first hop strictly below the threshold from rf
        #   on: rf itself, or the start of the next run below (n: never);
        reset = np.where(below[k, rf], rf, np.append(b, n)[np.searchsorted(b, rf)])
        # - the next fire opens the first run above after the reset
        #   (len(a): none).
        succ = np.searchsorted(a, reset + 1).tolist()
        # The chain of fires from the first run above; succ[i] > i.
        chain, i = [], 0
        while i < len(succ):
            chain.append(i)
            i = succ[i]
        fires = a[chain]
        # a threshold given twice fills its lists twice, as the replay does
        fw, fwc = found[th]
        now = tms[fires].tolist()
        fw.extend([target_name, t] for t in now)
        fwc.extend([target_name, t, s] for t, s in zip(now, sc[fires].tolist()))

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
