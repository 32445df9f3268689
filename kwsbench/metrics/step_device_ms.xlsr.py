"""Device busy a training step inside the traced call's first epoch, ms:
the union of device intervals from the first step's augment kernel to the
last step's, over the steps between (steps - 1). Each step launches the
augment kernel once; the XLS-R call has no BN calibration after its steps,
so the last step's own launch closes the stretch."""


def read(trace, spans, counts):
    steps = counts.get("traced_steps")
    if trace is None or not steps or steps < 2:
        return None
    marks = trace.starts_of("augment_quantize_kernel")
    if len(marks) < steps:
        return None
    return trace.busy_between(int(marks[0]), int(marks[steps - 1])) / (steps - 1) * 1e3
