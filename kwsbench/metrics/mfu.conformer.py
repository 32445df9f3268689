"""The whole Conformer pretraining call's share of the card's float32 peak:
training operations a clip (``counts/wav2vec2_conformer.py``, ``linear_pos``
once a batch) at the samples the trunk's ``w2v.features`` span and the
frames its ``conformer.encoder`` span recorded x clips stepped / traced
window / 67 TFLOP/s, %; None where the program recorded no such span."""

from kwsbench import program_spans
from kwsbench.counts import wav2vec2_conformer as ccounts
from kwsbench.counts.model import PEAK_FP32_FLOPS


def read(trace, spans, counts):
    if trace is None or not counts.get("steps") or "dims" not in counts:
        return None
    found = program_spans.attribution(trace)
    if found is None:
        return None
    samples = {s.counts.get("samples") for s in found.spans if s.name == "w2v.features"}
    frames = {s.counts.get("frames") for s in found.spans if s.name == "conformer.encoder"}
    # the training steps' shape: one clip length a call
    if len(samples) != 1 or len(frames) != 1 or None in samples | frames:
        return None
    flops = ccounts.train_flops(counts["dims"], counts["num_labels"], counts["batch"], samples.pop(), frames.pop())
    clips = counts["steps"] * counts["batch"]
    return flops * clips / trace.window_s / PEAK_FP32_FLOPS * 100.0
