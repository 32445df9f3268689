"""Checkpoints: a model's ``state_dict`` with KWS metadata.

Counterpart of ``multilingual_kws_tpu/train/checkpoints.py`` (which writes
orbax trees): a checkpoint is a directory holding ``state.pt``, the
``state_dict`` through ``torch.save`` (BN running statistics included), and
``kws_metadata.json``. The embedding layer is named by the metadata
(``embedding_output``), not by a Keras layer name (reference
transfer_learning.py:41).

Saves are crash-safe as in the JAX package: the new checkpoint is built in
``<path>.saving`` (the state first, the metadata last with ``fsync``, as the
mark of a complete save), then swapped in by two renames (``path`` ->
``<path>.prev``, ``.saving`` -> ``path``) and ``.prev`` is dropped. A kill
at any point leaves a loadable checkpoint; loading recovers the newest
complete one, in the order ``.saving``, ``path``, ``.prev``.

The JAX package's checkpoints (an orbax ``state/`` directory) are refused:
convert one by loading it with the JAX package's ``load_model``, turning the
trees into a ``state_dict`` with ``models/convert.flax_to_state_dict`` and
saving that with ``save_model`` here (``tests/test_torch_checkpoints.py``,
``convert_jax_checkpoint``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from .. import resolve_device
from ..models.efficientnet import EfficientNet
from ..models.kws_model import KWSTransferModel
from ..models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from ..models.wav2vec2_conformer import Wav2Vec2ConformerConfig, Wav2Vec2ConformerTrunk

Trunk = Union[EfficientNet, Wav2Vec2Trunk, Wav2Vec2ConformerTrunk]

METADATA_FILE = "kws_metadata.json"
STATE_FILE = "state.pt"
FORMAT = "multilingual_kws_tpu_torch.v1"
JAX_FORMAT = "multilingual_kws_tpu.v1"
EMBEDDING_PREFIXES = ("trunk", "embedding_head")
BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _sibling(path: Path, suffix: str) -> Path:
    return path.parent / (path.name + suffix)


def save_model(
    path,
    model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
    metadata: Optional[Dict] = None,
) -> None:
    """Save a model's ``state_dict`` (its tensors on the host) with
    metadata, crash-safely (module docstring). ``format`` is always this
    package's; ``has_batch_stats`` says whether BN running statistics are in
    the state."""
    sd = model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module) else model_or_state_dict
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    path = Path(path).resolve()
    tmp, prev = _sibling(path, ".saving"), _sibling(path, ".prev")
    for stale in (tmp, prev):
        if stale.exists():
            shutil.rmtree(stale)
    tmp.mkdir(parents=True)
    with open(tmp / STATE_FILE, "wb") as fh:
        torch.save(sd, fh)
        fh.flush()
        os.fsync(fh.fileno())
    meta = dict(metadata or {})
    meta["format"] = FORMAT
    meta.setdefault("embedding_output", "embedding_head/dense_2")
    meta["has_batch_stats"] = any(k.endswith(".running_mean") for k in sd)
    with open(tmp / METADATA_FILE, "w") as fh:
        json.dump(meta, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    # each step is one rename; a kill leaves at worst {path missing, .prev
    # complete}, which _resolve_checkpoint_dir recovers
    if path.exists():
        path.rename(prev)
    tmp.rename(path)
    if prev.exists():
        shutil.rmtree(prev)


def _resolve_checkpoint_dir(path: Path) -> Path:
    """The directory holding the newest complete checkpoint for ``path``
    (its metadata present): a complete ``.saving`` postdates ``path``
    (``save_model`` clears a stale one before building), then ``path``,
    then ``.prev`` (killed between the two renames)."""
    for cand in (_sibling(path, ".saving"), path, _sibling(path, ".prev")):
        if (cand / METADATA_FILE).is_file():
            return cand
    return path  # the caller's open() raises the natural error


def load_metadata(path) -> Dict:
    with open(_resolve_checkpoint_dir(Path(path).resolve()) / METADATA_FILE) as fh:
        return json.load(fh)


def load_model(path, device="cuda") -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``(state_dict on device, metadata)`` of the newest complete
    checkpoint at ``path``."""
    dev = resolve_device(device)
    ckpt = _resolve_checkpoint_dir(Path(path).resolve())
    with open(ckpt / METADATA_FILE) as fh:
        meta = json.load(fh)
    if meta.get("format") == JAX_FORMAT or (ckpt / "state").is_dir():
        raise ValueError(
            f"{ckpt} is a checkpoint of the JAX package (orbax): load it with "
            "multilingual_kws_tpu.train.checkpoints.load_model, convert the trees with "
            "multilingual_kws_tpu_torch.models.convert.flax_to_state_dict and save the "
            "state_dict with multilingual_kws_tpu_torch.train.checkpoints.save_model"
        )
    if meta.get("format") != FORMAT:
        raise ValueError(f"{ckpt}: unknown checkpoint format {meta.get('format')!r}")
    state = torch.load(ckpt / STATE_FILE, weights_only=True, map_location=dev)
    return state, meta


def load_embedding_variables(path, device="cuda") -> Dict[str, torch.Tensor]:
    """The trunk and embedding head of a saved model, parameters and the
    trunk's BN statistics, as ``state_dict`` entries: the reference's
    load-and-truncate at "dense_2" (transfer_learning.py:36-43), by key
    prefix instead of Keras layer surgery."""
    state, _ = load_model(path, device)
    return {k: v for k, v in state.items() if k.split(".")[0] in EMBEDDING_PREFIXES}


def load_embedding_params(path, device="cuda") -> Dict[str, torch.Tensor]:
    """Parameters-only view of ``load_embedding_variables``."""
    return {
        k: v for k, v in load_embedding_variables(path, device).items() if k.rsplit(".", 1)[-1] not in BN_STATS
    }


def load_transfer_model(path, device="cuda", compute_dtype=None) -> Tuple[KWSTransferModel, Dict]:
    """A saved transfer model, in eval mode on ``device``, its trunk rebuilt
    from the metadata by ``sized_trunk`` (an EfficientNet of the recorded
    width, depth and input prefix; a wav2vec 2.0 or Conformer trunk, which
    ``KWSTransferModel`` refuses) and computing in ``compute_dtype`` (None:
    float32; the tensors stay float32). The model is built without storage
    (the meta device) and takes the loaded tensors as its own: no
    initialization, no second copy."""
    state, meta = load_model(path, device)
    with torch.device("meta"):
        model = KWSTransferModel(sized_trunk(meta, compute_dtype), num_categories=3)
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval(), meta


def trunk_metadata(trunk: Trunk) -> Dict:
    """The metadata ``sized_trunk`` rebuilds ``trunk`` from, the one place
    a checkpoint's trunk is described. An EfficientNet: its width and depth
    coefficients, and its input prefix where it is not Keras' default (so
    that a default trunk's checkpoint has the JAX package's keys). A
    wav2vec 2.0 trunk: ``trunk: "wav2vec2"`` and its ``Wav2Vec2Config``'s
    fields under ``wav2vec2``. A Conformer trunk: ``trunk:
    "wav2vec2_conformer"`` and its ``Wav2Vec2ConformerConfig``'s fields under
    ``wav2vec2_conformer``."""
    if isinstance(trunk, Wav2Vec2Trunk):
        return {"trunk": "wav2vec2", "wav2vec2": dataclasses.asdict(trunk.config)}
    if isinstance(trunk, Wav2Vec2ConformerTrunk):
        return {"trunk": "wav2vec2_conformer", "wav2vec2_conformer": dataclasses.asdict(trunk.config)}
    meta = {"width_coefficient": trunk.width_coefficient, "depth_coefficient": trunk.depth_coefficient}
    if (trunk.input_scale, trunk.input_bias) != (1.0 / 255.0, 0.0):
        meta.update(input_scale=trunk.input_scale, input_bias=trunk.input_bias)
    return meta


def sized_trunk(meta: Mapping, compute_dtype=None) -> Trunk:
    """The trunk a checkpoint's metadata describes (``trunk_metadata``),
    computing in ``compute_dtype``. Without a ``trunk`` key, an EfficientNet
    with the recorded width and depth coefficients (absent: 1.0, B0) and
    input prefix (``input_scale`` / ``input_bias``, as ``import-tf`` records
    a Keras model's; absent: Keras' default 1/255 and 0). With ``trunk:
    "wav2vec2"``, a ``Wav2Vec2Trunk`` of the recorded config; with ``trunk:
    "wav2vec2_conformer"``, a ``Wav2Vec2ConformerTrunk`` of its. Any other
    kind is refused: the metadata comes from outside the program."""
    kind = meta.get("trunk")
    if kind == "wav2vec2":
        return Wav2Vec2Trunk(Wav2Vec2Config.from_dict(meta["wav2vec2"]), compute_dtype)
    if kind == "wav2vec2_conformer":
        return Wav2Vec2ConformerTrunk(Wav2Vec2ConformerConfig.from_dict(meta["wav2vec2_conformer"]), compute_dtype)
    if kind is not None:
        raise ValueError(f"checkpoint metadata names an unknown trunk {kind!r}: the known trunks are "
                         "'wav2vec2_conformer', 'wav2vec2' and EfficientNet (no 'trunk' key)")
    return EfficientNet(
        width_coefficient=float(meta.get("width_coefficient", 1.0)),
        depth_coefficient=float(meta.get("depth_coefficient", 1.0)),
        input_scale=float(meta.get("input_scale", 1.0 / 255.0)),
        input_bias=float(meta.get("input_bias", 0.0)),
        compute_dtype=compute_dtype,
    )


class BestValCheckpoint:
    """ModelCheckpoint(save_best_only=True, monitor=val_accuracy) parity:
    saves only when the monitored metric improves."""

    def __init__(self, directory, monitor: str = "val_accuracy"):
        self.directory = Path(directory)
        self.monitor = monitor
        self.best: Optional[float] = None

    def update(self, metrics: Dict, model_or_state_dict, extra_meta: Optional[Dict] = None) -> bool:
        val = float(metrics[self.monitor])
        if self.best is not None and val <= self.best:
            return False
        self.best = val
        meta = dict(extra_meta or {})
        meta[self.monitor] = val
        save_model(self.directory, model_or_state_dict, meta)
        return True
