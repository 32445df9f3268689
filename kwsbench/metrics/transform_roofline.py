"""The training transform's kernels' share of their roofline inside the
traced call's first epoch: the least time of B4 (``augment_quantize``) and
B1 (``clip_features``) at the step's batch (``counts/frontend.py``,
data-sheet peaks) times the steps, over their device time in the epoch, %."""


def read(trace, spans, counts):
    steps = counts.get("traced_steps")
    if trace is None or not steps:
        return None
    marks = trace.starts_of("augment_quantize_kernel")
    if len(marks) <= steps:
        return None
    t = trace.kernel_s("augment_quantize_kernel", "clip_features_kernel", lo=int(marks[0]), hi=int(marks[steps]))
    if not t:
        return None
    return counts["transform_least_s"] * steps / t * 100.0
