"""CUDA graphs a fine-tune call leaves alive: the program's ``graphs_kept``
count at the close of its last traced ``finetune.call`` less that at its
first, over the calls between; None with fewer than two calls."""

from kwsbench import program_spans


def read(trace, spans, counts):
    found = program_spans.attribution(trace)
    if found is None:
        return None
    kept = [s.counts["graphs_kept"] for s in found.roots("finetune.call") if "graphs_kept" in s.counts]
    if len(kept) < 2:
        return None
    return (kept[-1] - kept[0]) / (len(kept) - 1)
