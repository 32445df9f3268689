"""The engine's detector and scoring a stream: the walls of the program's
``engine.detect`` and ``engine.score`` spans over its ``engine.scan`` calls, ms."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.per_root(trace, ("engine.detect", "engine.score"), "engine.scan", 1e-6)
