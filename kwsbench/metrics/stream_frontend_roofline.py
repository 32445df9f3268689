"""The stream frontend kernels' share of their roofline: the least time of
B2 (``stream_prefix``) and B3 (``stream_suffix``) at the cell's shapes
(``counts/frontend.py``, data-sheet peaks) over their device time in the
trace, %."""


def read(trace, spans, counts):
    if trace is None or "frontend_least_s" not in counts:
        return None
    t = trace.kernel_s("stream_prefix_kernel", "stream_suffix_kernel")
    if not t:
        return None
    return counts["frontend_least_s"] / t * 100.0
