"""The device's own gaps: the share of the traced window in which the device
is idle while the host waits on it inside a ``*.wait`` span
(``program_spans``), %."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.idle_share(trace, waiting=True)
