"""The whole pretraining call's share of the card's float32 peak: training
operations a clip (``counts/model.py``) x clips stepped / traced window /
67 TFLOP/s, %."""

from kwsbench.counts.model import PEAK_FP32_FLOPS


def read(trace, spans, counts):
    if trace is None or not counts.get("steps"):
        return None
    clips = counts["steps"] * counts["batch"]
    return counts["train_flops"] * clips / trace.window_s / PEAK_FP32_FLOPS * 100.0
