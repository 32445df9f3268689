"""A pretraining call's start-up (data set, model, optimizer, resident bank,
epoch program; the entry to the first epoch): the walls of the program's
``pretrain.start`` spans over its ``pretrain.call`` calls, s."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.per_root(trace, ("pretrain.start",), "pretrain.call", 1e-9)
