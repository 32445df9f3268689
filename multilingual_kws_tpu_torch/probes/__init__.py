"""Probes of the card: what its kernels and operation classes achieve.

Counterparts of the JAX package's ``tools_dev/probe_fft_cost.py`` and
``tools_dev/vpu_roofline.py``. They measure a CUDA device and raise without
one; they write no file.
"""

import time

import torch

from .. import resolve_device

# clock cycles a second of torch.cuda._sleep's spin: the card's maximum SM
# clock (1.98 GHz on an H100 SXM), so the spin lasts at least as long as asked
SPIN_CYCLES_PER_S = 1.98e9


def cuda_device(device) -> torch.device:
    """``device`` as a CUDA device; raises for any other (a probe of the CPU
    would measure nothing of the card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes measure a CUDA device, got {dev}")
    return dev


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over iters back-to-back calls, by CUDA
    events. The device first spins for about twice the host time the calls
    take to enqueue (one call's wall, synchronized, bounds it), so the host
    is ahead when the first call starts and the events time the kernels
    back to back, not the host's launches: a small-shape call whose host
    side outlasts its kernel is timed by its kernel. fn must not
    synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ahead_s = min(2 * iters * (time.perf_counter() - t), 0.5)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(ahead_s * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
