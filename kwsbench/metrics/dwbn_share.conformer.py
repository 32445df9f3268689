"""The convolution module's memory- and launch-bound part, as a share of
the training step's device time inside the traced call's first epoch, %:
the device time of the depthwise convolution's kernels (forward, data and
weight gradients) and of BatchNorm's (statistics, transform, backward
reduce and elementwise) over the device busy from the first step's augment
kernel to the last step's. In this cell only the Conformer blocks launch
BatchNorm or depthwise kernels, so the names attribute cleanly."""

# the names the H100's trace gives these kernels (torch's CUDA kernels for a
# float32 depthwise convolution and a float32 BatchNorm1d in training; and
# cuDNN's BatchNorm engines, should torch hand the batch norm to cuDNN)
DEPTHWISE_BN = ("conv_depthwise", "batch_norm_", "bn_fw_", "bn_bw_")


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
    return (trace.kernel_s(*DEPTHWISE_BN, lo=lo, hi=hi) or 0.0) / busy * 100.0
