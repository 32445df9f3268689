"""The device idle while the host works: the share of the traced window in
which the device is idle and the host's innermost program span is not a
``*.wait`` span (``program_spans``), %."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.idle_share(trace, waiting=False)
