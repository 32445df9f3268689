"""The convolutions' share of the training step's device time inside the
traced call's first epoch, %: the device time of the kernels whose names
hold a fragment of ``CONV`` (the forward, data-gradient and weight-gradient
kernels of the feature encoder's and the positional convolution's Conv1d,
and cuDNN's layout kernels around them) over the device busy from the first
step's augment kernel to the last step's."""

# the names the H100's trace gives the convolutions' kernels (torch 2.11,
# cuDNN): the cuDNN engines' implicit-GEMM forward, data- and weight-gradient
# kernels ("..._cudnn", "cudnn::detail::dgrad_engine"), their layout and
# scale kernels ("cudnn::engines_precompiled::..."), and the legacy engines
# outside cuDNN's namespace that the first convolutions get
CONV = ("cudnn", "implicit_convolve_sgemm", "wgrad_alg0_engine")


def read(trace, spans, counts):
    steps = counts.get("traced_steps")
    if trace is None or not steps or steps < 2:
        return None
    marks = trace.starts_of("augment_quantize_kernel")
    if len(marks) < steps:
        return None
    lo, hi = int(marks[0]), int(marks[steps - 1])
    busy = trace.busy_between(lo, hi)
    if busy <= 0:
        return None
    return (trace.kernel_s(*CONV, lo=lo, hi=hi) or 0.0) / busy * 100.0
