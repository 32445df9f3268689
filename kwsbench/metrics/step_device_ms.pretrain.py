"""Device busy a training step inside the traced call's first epoch, ms:
the union of device intervals from the first step's augment kernel to the
first augment kernel after the epoch's steps (BN calibration's), over the
steps. Each step launches the augment kernel once."""


def read(trace, spans, counts):
    steps = counts.get("traced_steps")
    if trace is None or not steps:
        return None
    marks = trace.starts_of("augment_quantize_kernel")
    if len(marks) <= steps:
        return None
    return trace.busy_between(int(marks[0]), int(marks[steps])) / steps * 1e3
