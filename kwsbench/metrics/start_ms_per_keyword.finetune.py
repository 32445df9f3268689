"""A fine-tune call's start-up (model, base weights, data set, bank): the
walls of the program's ``finetune.start`` spans over its ``finetune.call``
calls, ms."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.per_root(trace, ("finetune.start",), "finetune.call", 1e-6)
