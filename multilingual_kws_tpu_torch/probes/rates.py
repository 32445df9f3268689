"""The card's achievable rates per operation class, measured by two CUDA
kernels and their plain PyTorch versions.

Counterpart of ``tools_dev/vpu_roofline.py::measure_rates`` (its Pallas
kernels ``_rate_kernel`` and ``_dot_rate_kernel``); the kernels are
``rate_chain`` and ``dot_chain`` in ``csrc/probes.cu``.

- ``rate_chain(x, y, op, k)``: k dependent passes of one operation class
  over int32 arrays, arithmetic mod 2^32. Classes (``OPS_PER_PASS``, counted
  as the JAX probe counts them): ``alu`` (x + y) ^ y, ``mul`` x * y,
  ``cmpsel`` where((x & 1) == 0, y, x), ``shuffle`` (the cross-lane class:
  each aligned group of 32 elements rotates by one, x[i] <- x[i + 1], a warp
  shuffle on the card). ``copy`` returns x: the copy-bandwidth control.
- ``dot_chain(x, w, k)``: k dependent passes x <- float32(bf16(x) @ bf16(w))
  over (rows, 256) @ (256, 256) on the tensor cores (``wgmma``; w staged in
  shared memory from its swizzled image, ``swizzled_w``).

``measure_rates`` times each chain at two depths and differences them, so
that loads, stores and the launch drop out; each class's chain must grow
linearly in k between the depths, or the probe has measured nothing. With w
a permutation matrix and x integers in [-128, 128), every product pass is
exact in bf16, so the kernel is ``==`` its plain version.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..ops import _build
from . import cuda_device, cuda_ms

ROWS = 392 * 64  # the JAX probe's grid: 64 tiles of the TPU kernel's (392, 256) block
WIDTH = 256
OPS = {"alu": 0, "mul": 1, "cmpsel": 2, "shuffle": 3, "copy": 4}
OPS_PER_PASS = {"alu": 2, "mul": 1, "cmpsel": 3, "shuffle": 1}
_CHUNK = 1024  # elements per block of the kernel: 256 threads x 4 chains
# the two depths measure_rates differences: deep enough that the chains,
# not the 77 MB the kernel moves, take the time
DEPTHS = (512, 2048)
DOT_DEPTHS = (16, 64)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits (kept in int64)."""
    return ((v & 0xFFFFFFFF) ^ (1 << 31)) - (1 << 31)


def rate_chain_plain(x: torch.Tensor, y: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """Plain version on int64 masked to 32 bits (torch's int32 multiply is
    not guaranteed to wrap); any device."""
    v, w = x.to(torch.int64), y.to(torch.int64)
    if op != "copy":
        for _ in range(k):
            if op == "alu":
                v = _wrap32((v + w) ^ w)
            elif op == "mul":
                v = _wrap32(v * w)
            elif op == "cmpsel":
                v = torch.where((v & 1) == 0, w, v)
            else:
                v = v.reshape(-1, 32).roll(-1, dims=1).reshape(v.shape)
    return v.to(torch.int32)


def rate_chain(x: torch.Tensor, y: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """int32 x, y of one shape -> int32 after k passes of ``op``. Kernel on
    CUDA tensors, plain version on CPU tensors."""
    if op not in OPS:
        raise ValueError(f"unknown operation class {op!r}: one of {sorted(OPS)}")
    if x.shape != y.shape or x.numel() % _CHUNK:
        raise ValueError(f"rate_chain takes x, y of one shape, a multiple of {_CHUNK} elements")
    if x.device.type == "cpu":
        return rate_chain_plain(x, y, op, k)
    if x.device.type != "cuda":
        raise ValueError(f"rate_chain: unsupported device {x.device}")
    if x.dtype != torch.int32 or y.dtype != torch.int32 or not (x.is_contiguous() and y.is_contiguous()):
        raise TypeError("rate_chain takes contiguous int32 arrays")
    out = torch.empty_like(x)
    lib = _build.load("probes")
    with torch.cuda.device(x.device):
        err = lib.kws_rate_chain(
            x.data_ptr(), y.data_ptr(), x.numel(), k, OPS[op], out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "rate_chain")
    _build.count(rate_chain)
    return out


_build.counted(rate_chain)


def dot_chain_plain(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: k passes of ``(x.bfloat16() @ w.bfloat16()).float()``
    (one bf16 ``torch.matmul`` each); any device."""
    acc, wb = x.to(torch.float32), w.to(torch.bfloat16)
    for _ in range(k):
        acc = torch.matmul(acc.to(torch.bfloat16), wb).to(torch.float32)
    return acc


def swizzled_w(w: torch.Tensor) -> torch.Tensor:
    """(256, 256) w -> its transpose in bf16, flat, in the layout the
    kernel's shared memory holds (``swz`` in ``csrc/probes.cu``): w^T[n, c]
    at (c // 64) * 256 * 64 + n * 64 + (((c // 8) % 8) ^ (n % 8)) * 8 + c % 8,
    four 64-column slabs of 128-byte rows, each row's 16-byte chunks
    permuted by the 128-byte swizzle, so the kernel stages it with linear
    bulk copies."""
    n = torch.arange(WIDTH, device=w.device)[:, None]
    c = torch.arange(WIDTH, device=w.device)[None, :]
    pos = (c // 64) * WIDTH * 64 + n * 64 + (((c // 8) % 8) ^ (n % 8)) * 8 + c % 8
    img = torch.empty(WIDTH * WIDTH, dtype=torch.bfloat16, device=w.device)
    img[pos.reshape(-1)] = w.to(torch.bfloat16).t().reshape(-1)
    return img


def dot_chain(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, 256) float32 x, (256, 256) w -> (rows, 256) float32 after k
    passes. Kernel on CUDA tensors (rows a multiple of 64), plain version on
    CPU tensors."""
    if x.dim() != 2 or x.shape[1] != WIDTH or tuple(w.shape) != (WIDTH, WIDTH):
        raise ValueError(f"dot_chain takes (rows, 256) @ (256, 256), got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu":
        return dot_chain_plain(x, w, k)
    if x.device.type != "cuda":
        raise ValueError(f"dot_chain: unsupported device {x.device}")
    return launch_dot_chain(x, swizzled_w(w), k)


def launch_dot_chain(x: torch.Tensor, w_img: torch.Tensor, k: int):
    """The kernel on CUDA x and w's image (``swizzled_w``).
    ``measure_rates`` makes the image once and times this, so its loop
    times the kernel and not the image's dozen small launches."""
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2 or x.shape[1] != WIDTH or x.shape[0] % 64:
        raise TypeError("dot_chain takes contiguous float32 (rows, 256), rows a multiple of 64")
    if w_img.dtype != torch.bfloat16 or w_img.numel() != WIDTH * WIDTH or w_img.device != x.device:
        raise TypeError("dot_chain takes w's bf16 image (swizzled_w) on x's device")
    out = torch.empty_like(x)
    lib = _build.load("probes")
    with torch.cuda.device(x.device):
        err = lib.kws_dot_chain(
            x.data_ptr(), w_img.data_ptr(), x.shape[0], k, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "dot_chain")
    _build.count(dot_chain)
    return out


_build.counted(dot_chain)


def probe_inputs(device, seed: int = 0, rows: int = ROWS):
    """The probes' seeded inputs on ``device``: int32 x in [-2^14, 2^14) and
    y in [1, 2^10) (the JAX probe's), the dot chain's integer x in [-128,
    128) as float32 and a (256, 256) permutation matrix."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-(2**14), 2**14, (rows, WIDTH)).astype(np.int32)).to(device)
    y = torch.from_numpy(rng.integers(1, 2**10, (rows, WIDTH)).astype(np.int32)).to(device)
    xd = torch.from_numpy(rng.integers(-128, 128, (rows, WIDTH)).astype(np.float32)).to(device)
    perm = np.eye(WIDTH, dtype=np.float32)[rng.permutation(WIDTH)]
    return x, y, xd, torch.from_numpy(perm).to(device)


def measure_rates(
    device="cuda", depths: Sequence[int] = DEPTHS, dot_depths: Sequence[int] = DOT_DEPTHS,
    iters: int = 10, seed: int = 0, copy_rows: int = 16 * ROWS,
) -> Dict[str, dict]:
    """Time each chain at k = 0 and the two depths by CUDA events. Returns,
    per class, ops/s from the difference of the two depths and the
    linearity ratio ((t(k2) - t(0)) / k2) / ((t(k1) - t(0)) / k1), which is
    1 for a chain that scales; the copy's bytes/s (x read, out written) on
    ``copy_rows`` rows, 16x the chains' 25.7 MB so that neither the 50 MB L2
    nor the launch's ramp hides the memory rate; the dot chain's FLOP/s and
    one bf16 ``torch.matmul`` pass's time."""
    dev = cuda_device(device)
    x, y, xd, w = probe_inputs(dev, seed)
    n = x.numel()
    k1, k2 = depths
    out: Dict[str, dict] = {}
    for op, per_pass in OPS_PER_PASS.items():
        t = {k: cuda_ms(lambda: rate_chain(x, y, op, k), iters) for k in (0, k1, k2)}
        out[op] = {
            "ops_per_s": n * per_pass * (k2 - k1) / ((t[k2] - t[k1]) * 1e-3),
            "ms": t,
            "linearity": ((t[k2] - t[0]) / k2) / ((t[k1] - t[0]) / k1),
        }
    big = torch.zeros((copy_rows, WIDTH), dtype=torch.int32, device=dev)
    t_copy = cuda_ms(lambda: rate_chain(big, big, "copy", 0), iters)
    out["copy"] = {"bytes_per_s": 2 * big.numel() * 4 / (t_copy * 1e-3), "ms": t_copy}
    del big
    d1, d2 = dot_depths
    w_img = swizzled_w(w)
    t = {k: cuda_ms(lambda: launch_dot_chain(xd, w_img, k), iters) for k in (0, d1, d2)}
    flop_per_pass = 2 * xd.shape[0] * WIDTH * WIDTH
    xb, wb = xd.to(torch.bfloat16), w.to(torch.bfloat16)
    out["dot_bf16"] = {
        "flop_per_s": flop_per_pass * (d2 - d1) / ((t[d2] - t[d1]) * 1e-3),
        "ms": t,
        "linearity": ((t[d2] - t[0]) / d2) / ((t[d1] - t[0]) / d1),
        "matmul_pass_ms": cuda_ms(lambda: torch.matmul(xb, wb), iters * 4),
    }
    return out
