"""Data parallelism over processes: the counterpart of the JAX package's
``parallel/mesh.py`` in terms of ``torch.distributed``.

The JAX package shards one global batch over the devices of a mesh and lets
XLA insert the collectives. Here each process (one per card) holds its rows
of the global batch and the collectives are explicit:

- ``initialize_distributed`` joins the process group (NCCL on the card, gloo
  on the CPU); in a single process with no ``WORLD_SIZE`` / ``MASTER_ADDR``
  in the environment it does nothing, and every helper below then sees one
  rank;
- ``world_size``, ``rank`` and ``local_rows`` say which rows of a global
  batch this process holds: rank r of W holds the r-th of W equal,
  contiguous blocks;
- ``pad_to_multiple`` pads a batch so that it divides over the ranks (the
  JAX package's contract: edge padding, the real count returned);
- ``make_sharded_predict`` spreads a predictor's rows over the ranks (the
  window-axis parallelism of the stream predict) and gathers the result.

The pretraining step (``train/steps.make_pretrain_step``) averages gradients
over the group with one all-reduce of them all; train-mode BatchNorm and
drop-connect (``models/efficientnet.py``) read ``world_size`` and ``rank``
of the default group so that a step on W processes is the step of one
process on the global batch.

Launch W processes with ``torchrun --nproc_per_node W ...`` (which sets the
environment ``initialize_distributed`` reads), or pass ``init_method``,
``world_size`` and ``rank`` explicitly.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: timedelta = timedelta(minutes=10),
) -> bool:
    """Join the default process group; returns whether one is up.

    Explicit ``init_method`` / ``world_size`` / ``rank`` win; otherwise the
    environment's (``env://``: ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as torchrun sets them). With neither, a single process
    stays without a group (a no-op). ``backend`` defaults to NCCL when CUDA
    is available and gloo otherwise; with NCCL the process's card is
    ``LOCAL_RANK`` (default: the ``rank`` given, else 0)."""
    if dist.is_initialized():
        return True
    env = "WORLD_SIZE" in os.environ or "MASTER_ADDR" in os.environ
    if init_method is None and not env:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if init_method is None:
        init_method = "env://"
    if world_size is None and init_method != "env://":
        raise ValueError("initialize_distributed: an explicit init_method needs world_size and rank")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    kw = {} if world_size is None else {"world_size": world_size, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kw)
    return True


def world_size() -> int:
    """Ranks of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def default_group():
    """The default process group, or None in a single process without one."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def local_rows(global_batch: int, shard: Optional[Tuple[int, int]] = None) -> slice:
    """This process's rows of a global batch: the ``rank``-th of
    ``world_size`` equal contiguous blocks. ``shard`` = (rank, world size)
    overrides the default group's. Raises if the batch does not divide."""
    r, w = shard if shard is not None else (rank(), world_size())
    if global_batch % w:
        raise ValueError(f"a global batch of {global_batch} rows does not divide over {w} ranks")
    n = global_batch // w
    return slice(r * n, (r + 1) * n)


def pad_to_multiple(batch, multiple: int, axis: int = 0):
    """Pad a batch (numpy array or tensor) along ``axis`` to a multiple of
    ``multiple`` by repeating its last entry (numpy's "edge" mode); returns
    (padded, real_count)."""
    n = batch.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    if isinstance(batch, torch.Tensor):
        idx = torch.cat([torch.arange(n), torch.full((rem,), n - 1)]).to(batch.device)
        return batch.index_select(axis, idx), n
    pad_widths = [(0, 0)] * batch.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(batch, pad_widths, mode="edge"), n


def make_sharded_predict(predict_fn: Callable, pad_batch_to: int = 1) -> Callable:
    """Wrap a (B, ...) -> (B, ...) predictor so that each rank predicts its
    share of the rows: the batch (the same on every rank) is padded to a
    multiple of ``world_size * pad_batch_to``, each rank runs its rows, the
    results are gathered over the group (``all_gather``) and the padding is
    stripped. In a single process it is ``predict_fn`` on the padded batch.
    The result is a tensor on ``predict_fn``'s device."""

    def wrapped(batch):
        batch = torch.as_tensor(batch)
        w = world_size()
        padded, real = pad_to_multiple(batch, max(w * pad_batch_to, 1))
        out = torch.as_tensor(predict_fn(padded[local_rows(padded.shape[0])])).contiguous()
        if w > 1:
            parts = [torch.empty_like(out) for _ in range(w)]
            dist.all_gather(parts, out)
            out = torch.cat(parts)
        return out[:real]

    return wrapped
