"""CUDA-graph capture a keyword: the walls of the program's ``graphs.capture``
spans inside its ``finetune.call`` calls over those calls, ms."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.per_root(trace, ("graphs.capture",), "finetune.call", 1e-6, inside=True)
