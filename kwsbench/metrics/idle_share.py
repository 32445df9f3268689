"""The device's idle share of the traced window: 1 - busy / window, %."""


def read(trace, spans, counts):
    if trace is None or trace.window_s <= 0:
        return None
    return (1.0 - trace.busy_s / trace.window_s) * 100.0
