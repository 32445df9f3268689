"""A fine-tune call's evaluations: the walls of the program's
``finetune.evaluate`` spans over its ``finetune.call`` calls, ms."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.per_root(trace, ("finetune.evaluate",), "finetune.call", 1e-6)
