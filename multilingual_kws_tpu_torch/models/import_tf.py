"""TF/Keras -> the port's weights, for the reference's Keras KWS models.

Counterpart of ``multilingual_kws_tpu/models/import_tf.py``. The reference
ships its pretrained multilingual embedding as a Keras SavedModel
(EfficientNetB0 include_top=False + GAP + Dense1024 relu x2 + Dense192 selu
["dense_2"] + Dense logits; train_monolingual_embedding.py:81-100) and its
few-shot transfer models as the truncated trunk + Dense18 tanh + Dense3
softmax (transfer_learning.py:38-53). This module maps those weights tensor
by tensor onto ``KWSEmbeddingModel`` / ``KWSTransferModel``, so the released
checkpoint (``multilingual_context_73_0.8011``) can be fine-tuned here.

Two halves:

- **TF-free** (numpy and torch; it runs on the card's machine, which has no
  TensorFlow): ``import_weight_map`` takes a Keras layer name -> that layer's
  weights in ``get_weights()`` order, and the dense layers' names in graph
  order, and returns the port's ``state_dict`` with the folded input
  prefix; ``model_from_import`` builds the model from it.
- **TF** (``load_keras_model``, ``import_keras_kws_model``,
  ``import_savedmodel_kws_model``, ``import_tf_checkpoint``,
  ``convert_and_save``): they read Keras models and SavedModels, and import
  ``tensorflow`` inside the function (importing it also loads JAX through
  Keras 3, which the port otherwise never imports).

Layer names (Keras -> the port's module path):

  stem_conv / stem_bn                 -> trunk.stem.{conv,bn}
  block{S}{r}_expand_conv|_expand_bn  -> trunk.block{S}{r}.{expand_conv,expand_bn}
  block{S}{r}_dwconv|_bn              -> trunk.block{S}{r}.{dw_conv,dw_bn}
  block{S}{r}_se_reduce|_se_expand    -> trunk.block{S}{r}.{se_reduce,se_expand}
  block{S}{r}_project_conv|_project_bn-> trunk.block{S}{r}.{project_conv,project_bn}
  top_conv / top_bn                   -> trunk.top.{conv,bn}
  dense layers (graph order)          -> embedding_head.dense_0, dense_1, dense_2
                                         (the 192-d embedding), then classifier
                                         or transfer_head.hidden, .out

Layouts: Keras Conv2D kernels are (H, W, Cin, Cout), torch's (Cout, Cin, H,
W); DepthwiseConv2D (H, W, C, mult) -> (C * mult, 1, H, W); Dense (in, out)
-> (out, in); BN (gamma, beta, moving_mean, moving_variance) -> weight, bias,
running_mean, running_var (eps 1e-3 on both sides). The Keras Rescaling(1/255)
+ Normalization prefix folds into the trunk's ``input_scale`` /
``input_bias``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .efficientnet import EfficientNetB0
from .kws_model import KWSEmbeddingModel, KWSTransferModel

# Keras block layer suffix -> the port's module name inside the block
BLOCK_LAYERS = {
    "expand_conv": "expand_conv",
    "expand_bn": "expand_bn",
    "dwconv": "dw_conv",
    "bn": "dw_bn",
    "se_reduce": "se_reduce",
    "se_expand": "se_expand",
    "project_conv": "project_conv",
    "project_bn": "project_bn",
}
EMBEDDING_DENSE = ("embedding_head.dense_0", "embedding_head.dense_1", "embedding_head.dense_2")
EMBEDDING_TAIL = ("classifier",)
TRANSFER_TAIL = ("transfer_head.hidden", "transfer_head.out")


def trunk_module(layer_name: str) -> Optional[str]:
    """The port's module path of a Keras trunk layer ("block2a_dwconv" ->
    "trunk.block2a.dw_conv"); None for a layer with no counterpart."""
    if layer_name in ("stem_conv", "stem_bn", "top_conv", "top_bn"):
        block, kind = layer_name.split("_")
        return f"trunk.{block}.{kind}"
    if layer_name.startswith("block") and "_" in layer_name:
        block, suffix = layer_name.split("_", 1)
        if suffix in BLOCK_LAYERS:
            return f"trunk.{block}.{BLOCK_LAYERS[suffix]}"
    return None


def _conv(path: str, weights: list, depthwise: bool) -> Dict[str, torch.Tensor]:
    k = np.asarray(weights[0], np.float32)
    if depthwise:  # (H, W, C, mult) -> (H, W, 1, C * mult), a grouped conv
        h, w, c, m = k.shape
        k = k.reshape(h, w, 1, c * m)
    out = {f"{path}.weight": torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))}
    if len(weights) == 2:
        out[f"{path}.bias"] = torch.from_numpy(np.array(weights[1], np.float32))
    return out


def _bn(path: str, weights: list) -> Dict[str, torch.Tensor]:
    names = ("weight", "bias", "running_mean", "running_var")
    out = {f"{path}.{n}": torch.from_numpy(np.array(w, np.float32)) for n, w in zip(names, weights)}
    out[f"{path}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def _dense(path: str, weights: list) -> Dict[str, torch.Tensor]:
    return {
        f"{path}.weight": torch.from_numpy(np.ascontiguousarray(np.asarray(weights[0], np.float32).T)),
        f"{path}.bias": torch.from_numpy(np.array(weights[1], np.float32)),
    }


def import_weight_map(by_name: Dict[str, list], dense_order: List[str]) -> Dict[str, Any]:
    """The TF-free core. ``by_name``: Keras layer name -> its weights in
    ``get_weights()`` order; ``dense_order``: the dense layers' names in
    graph order. Returns dict(state_dict, input_scale, input_bias, kind
    ("embedding" | "transfer"), num_outputs)."""
    # the input prefix: Rescaling(1/255), then a Normalization if it holds
    # one scalar mean and variance
    input_scale = 1.0 / 255.0
    input_bias = 0.0
    for lname, w in by_name.items():
        if lname.startswith("normalization") and len(w) >= 2:
            mean, var = np.ravel(w[0]), np.ravel(w[1])
            if mean.size == 1:
                s = 1.0 / float(np.sqrt(var[0]))
                input_scale *= s
                input_bias = -float(mean[0]) * s

    sd: Dict[str, torch.Tensor] = {}
    for lname, w in by_name.items():
        path = trunk_module(lname)
        if path is None:
            continue  # the prefix, and layers that carry no port weights
        if path.endswith("bn"):
            sd.update(_bn(path, w))
        else:
            sd.update(_conv(path, w, depthwise=path.endswith("dw_conv")))

    if len(dense_order) == 4:  # embedding model: 1024, 1024, 192, logits
        kind, paths = "embedding", EMBEDDING_DENSE + EMBEDDING_TAIL
    elif len(dense_order) == 5:  # transfer model: ... 192, 18 tanh, 3 softmax
        kind, paths = "transfer", EMBEDDING_DENSE + TRANSFER_TAIL
    else:
        raise ValueError(f"unrecognized head: {len(dense_order)} dense layers ({dense_order})")
    for path, name in zip(paths, dense_order):
        sd.update(_dense(path, by_name[name]))
    num_outputs = int(np.shape(by_name[dense_order[-1]][1])[0])
    return {
        "state_dict": sd,
        "input_scale": input_scale,
        "input_bias": input_bias,
        "kind": kind,
        "num_outputs": num_outputs,
    }


def model_from_import(imported: Dict[str, Any], device="cuda") -> torch.nn.Module:
    """The port model (``KWSEmbeddingModel`` or ``KWSTransferModel``, a
    full-width B0 trunk with the folded input prefix) holding an imported
    ``state_dict``, in eval mode on ``device``. Built without storage and
    loaded strictly: every tensor of the model must come from the import."""
    dev = resolve_device(device)
    with torch.device("meta"):
        trunk = EfficientNetB0(input_scale=imported["input_scale"], input_bias=imported["input_bias"])
        if imported["kind"] == "embedding":
            model = KWSEmbeddingModel(imported["num_outputs"], trunk)
        else:
            model = KWSTransferModel(trunk, num_categories=imported["num_outputs"])
    model.load_state_dict(imported["state_dict"], strict=True, assign=True)
    return model.to(dev).eval()


# -- the TF half ---------------------------------------------------------------


def _tensorflow():
    """``tensorflow``, kept off any GPU (the conversion is a host tool)."""
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    return tf


def iter_leaf_layers(keras_model):
    """Depth-first leaf layers, recursing into nested Models/Sequentials.

    The reference saves transfer models as Sequential([truncated base
    Model, Dense 18, Dense 3]) (transfer_learning.py:38-53, saved by
    run.py:299-300), so the trunk's layers are nested one level down."""
    for layer in keras_model.layers:
        if hasattr(layer, "layers") and layer.layers:
            yield from iter_leaf_layers(layer)
        else:
            yield layer


def keras_weights_by_layer(keras_model) -> Tuple[Dict[str, list], List[str]]:
    """A live Keras model -> (layer name -> weights, the dense layers' names
    in graph order). Nested models can reuse auto-generated names: a repeat
    gets "#" appended."""
    by_name: Dict[str, list] = {}
    dense_order: List[str] = []
    for layer in iter_leaf_layers(keras_model):
        w = layer.get_weights()
        if not w:
            continue
        name = layer.name
        while name in by_name:
            name += "#"
        by_name[name] = [np.asarray(a) for a in w]
        if layer.__class__.__name__ == "Dense":
            dense_order.append(name)
    return by_name, dense_order


def load_keras_model(path):
    """Load a Keras model file (``.keras`` / ``.h5``) from disk."""
    return _tensorflow().keras.models.load_model(path, compile=False)


def import_keras_kws_model(keras_model) -> Dict[str, Any]:
    """A live Keras KWS model (embedding or transfer shape) ->
    ``import_weight_map``'s dict."""
    return import_weight_map(*keras_weights_by_layer(keras_model))


# within-layer ordering of named variables == Keras get_weights() order
WEIGHT_RANK = {
    "kernel": 0, "depthwise_kernel": 0, "gamma": 0,  # conv/dense/bn first slot
    "bias": 1, "beta": 1,
    "moving_mean": 2, "moving_variance": 3,
    "mean": 0, "variance": 1, "count": 2,  # Normalization layer
}


def import_savedmodel_kws_model(path) -> Dict[str, Any]:
    """Name-based import of a TF SavedModel directory (the format of the
    reference's released ``multilingual_context_73_0.8011``).

    Keras 3 cannot ``load_model`` legacy Keras SavedModels, but
    ``tf.saved_model.load`` exposes every variable with its layer-pathed
    name (``block1a_dwconv/depthwise_kernel:0``): layer identity and the
    order within a layer follow from those names. Works for legacy Keras
    SavedModels and Keras 3 ``model.export()`` directories alike."""
    obj = _tensorflow().saved_model.load(str(path))
    grouped: Dict[str, list] = {}
    for v in obj.variables:
        parts = v.name.split(":")[0].split("/")
        if len(parts) < 2 or parts[-1] not in WEIGHT_RANK:
            continue
        grouped.setdefault(parts[-2], []).append((WEIGHT_RANK[parts[-1]], np.asarray(v)))
    by_name = {layer: [w for _, w in sorted(ws, key=lambda t: t[0])] for layer, ws in grouped.items()}

    def dense_sort_key(name: str):
        # Keras auto-names record creation order: dense, dense_1, dense_2, ...
        suffix = name.split("dense_")[-1]
        return int(suffix) if suffix.isdigit() else -1

    dense_order = sorted(
        (n for n, w in by_name.items()
         if n.startswith("dense") and len(w) == 2 and w[0].ndim == 2 and w[1].ndim == 1),
        key=dense_sort_key,
    )
    return import_weight_map(by_name, dense_order)


def import_tf_checkpoint(path, device="cuda") -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """A Keras model file or SavedModel directory -> (the port model in eval
    mode on ``device``, meta: kind, num_outputs, input_scale, input_bias)."""
    dev = resolve_device(device)
    if os.path.isfile(os.path.join(path, "saved_model.pb")):  # a SavedModel directory
        imported = import_savedmodel_kws_model(path)
    else:
        imported = import_keras_kws_model(load_keras_model(path))
    meta = {k: imported[k] for k in ("kind", "num_outputs", "input_scale", "input_bias")}
    return model_from_import(imported, dev), meta


def convert_and_save(tf_path, dest, device="cuda") -> None:
    """TF model -> the port's checkpoint (``train/checkpoints.py``), with the
    metadata that ``load_transfer_model`` and ``transfer_learn(
    base_model_path=...)`` size and scale the trunk from."""
    from ..train.checkpoints import save_model, trunk_metadata

    model, meta = import_tf_checkpoint(tf_path, device)
    save_model(dest, model, metadata={**meta, "source": str(tf_path), **trunk_metadata(model.trunk)})

