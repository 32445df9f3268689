"""The whole scan's share of the card's float32 peak: forward operations a
window (``counts/model.py``) x windows scanned / traced window / 67 TFLOP/s, %."""

from kwsbench.counts.model import PEAK_FP32_FLOPS


def read(trace, spans, counts):
    if trace is None or not counts.get("windows"):
        return None
    return counts["forward_flops"] * counts["windows"] / trace.window_s / PEAK_FP32_FLOPS * 100.0
