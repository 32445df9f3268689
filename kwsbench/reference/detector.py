"""The streaming detector, sequential, as the reference replays it: for each
threshold a fresh ``SingleTargetRecognizeCommands``
(single_target_recognize_commands.py:54-207 of harvard-edge/multilingual_kws)
fed every hop's softmax row in time order; a detection is each hop whose
result is new and is the target."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

SILENCE = "_silence_"


class Recognizer:
    """One threshold's averaging window, reliability gate and suppression."""

    def __init__(self, threshold: float, window_ms: int = 100, suppression_ms: int = 500,
                 minimum_count: int = 4, target_id: int = 2, target_name: str = "target"):
        self.threshold, self.window, self.suppression = threshold, window_ms, suppression_ms
        self.minimum_count, self.target_id, self.target_name = minimum_count, target_id, target_name
        self.times: List[int] = []
        self.scores: List[float] = []
        self.prev_top, self.prev_time = SILENCE, -math.inf

    def step(self, row, now_ms: int):
        """(label, score, is_new) for the newest row at ``now_ms``."""
        self.times.append(int(now_ms))
        self.scores.append(float(row[self.target_id]))
        while now_ms - self.window > self.times[0]:
            self.times.pop(0)
            self.scores.pop(0)
        if len(self.times) < self.minimum_count or now_ms - self.times[0] < self.window / 4:
            return self.prev_top, 0.0, False
        score = sum(self.scores) / len(self.scores)
        label = self.target_name if score > self.threshold else SILENCE
        since = math.inf if (self.prev_top == SILENCE or self.prev_time == -math.inf) else now_ms - self.prev_time
        new = False
        if score > self.threshold and label != self.prev_top and since > self.suppression:
            new = True
        elif score < self.threshold and label == SILENCE and since > self.suppression:
            new = True
        if new:
            self.prev_top, self.prev_time = label, now_ms
        return label, score, new


def detections(rows, times_ms: Sequence[int], threshold: float, target_name: str = "target",
               **params) -> List[List]:
    """[[target_name, time_ms], ...]: the target's new results over the rows."""
    rec = Recognizer(float(threshold), target_name=target_name, **params)
    found = []
    for row, t in zip(rows, times_ms):
        label, _, new = rec.step(row, int(t))
        if new and label == target_name:
            found.append([target_name, int(t)])
    return found


def detections_by_threshold(rows, times_ms, thresholds, target_name="target", **params) -> Dict[float, List[List]]:
    return {float(th): detections(rows, times_ms, th, target_name, **params) for th in thresholds}
