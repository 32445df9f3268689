"""The engine's host time a stream: (traced window - device busy) / streams, ms."""


def read(trace, spans, counts):
    if trace is None or not counts.get("streams"):
        return None
    return (trace.window_s - trace.busy_s) / counts["streams"] * 1e3
