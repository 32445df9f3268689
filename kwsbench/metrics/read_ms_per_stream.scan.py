"""The engine's wav read and int16 cast a stream: the walls of the program's
``engine.read_wav`` and ``engine.cast`` spans over its ``engine.scan`` calls, ms."""

from kwsbench import program_spans


def read(trace, spans, counts):
    return program_spans.per_root(trace, ("engine.read_wav", "engine.cast"), "engine.scan", 1e-6)
