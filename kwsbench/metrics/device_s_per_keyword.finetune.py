"""Device busy a keyword over the traced calls, s."""


def read(trace, spans, counts):
    if trace is None or not counts.get("keywords"):
        return None
    return trace.busy_s / counts["keywords"]
