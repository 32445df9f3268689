"""Flax ``{"params", "batch_stats"}`` trees (numpy leaves) -> ``state_dict``.

The port's modules carry the Flax names, so the path ``trunk/block2a/dw_conv``
becomes the key prefix ``trunk.block2a.dw_conv``. Leaves map as:

- conv kernel ``(kh, kw, in, out)`` -> ``weight (out, in, kh, kw)``; a
  depthwise kernel ``(kh, kw, 1, C)`` -> ``(C, 1, kh, kw)`` by the same
  transpose;
- Dense kernel ``(in, out)`` -> ``Linear.weight (out, in)``;
- ``bias`` -> ``bias``;
- BN ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``.

The tree is plain nested dicts of numpy arrays, so this needs no JAX: call
it with ``jax.tree_util.tree_map(np.asarray, variables)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` -> a ``state_dict`` for the
    port's model of the same architecture (``load_state_dict(strict=True)``
    accepts it)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables.get("params", {})):
        mod, name = ".".join(path[:-1]), path[-1]
        if name == "kernel" and leaf.ndim == 4:
            sd[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(leaf.transpose(3, 2, 0, 1)))
        elif name == "kernel" and leaf.ndim == 2:
            sd[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(leaf.T))
        elif name == "scale":
            sd[f"{mod}.weight"] = torch.from_numpy(leaf.copy())
        elif name == "bias":
            sd[f"{mod}.bias"] = torch.from_numpy(leaf.copy())
        else:
            raise KeyError(f"unmapped Flax parameter {'/'.join(path)} {leaf.shape}")
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        mod, name = ".".join(path[:-1]), path[-1]
        key = {"mean": "running_mean", "var": "running_var"}.get(name)
        if key is None:
            raise KeyError(f"unmapped Flax batch stat {'/'.join(path)}")
        sd[f"{mod}.{key}"] = torch.from_numpy(leaf.copy())
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
