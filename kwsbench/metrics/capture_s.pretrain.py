"""CUDA-graph capture a pretraining call: the walls of the program's
``graphs.capture`` spans inside its ``pretrain.call`` calls over those calls, s."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.per_root(trace, ("graphs.capture",), "pretrain.call", 1e-9, inside=True)
