"""Probes of the card: what its kernels and operation classes achieve.

Counterparts of the JAX package's ``tools_dev/probe_fft_cost.py`` and
``tools_dev/vpu_roofline.py``. They measure a CUDA device and raise without
one; they write no file.
"""

import torch

from .. import resolve_device


def cuda_device(device) -> torch.device:
    """``device`` as a CUDA device; raises for any other (a probe of the CPU
    would measure nothing of the card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes measure a CUDA device, got {dev}")
    return dev


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over iters back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
