"""The port's weights -> TF/Keras: the reverse of ``models/import_tf.py``.

Counterpart of ``multilingual_kws_tpu/models/export_tf.py``. A model trained
by the port flows back into the reference's TF tooling: the exported Keras
model has the reference's architecture and layer names
(train_monolingual_embedding.py:81-100 for the embedding model,
transfer_learning.py:38-53 for the transfer head), so reference code that
loads a base model and truncates it at layer "dense_2"
(transfer_learning.py:36-43) works on the port's checkpoints. Round trip:
``import_weight_map(m["by_name"], m["dense_order"])`` of ``m =
keras_weight_map(sd)`` gives ``sd`` back bitwise, and so does importing the
exported Keras model.

Two halves, as in ``import_tf``:

- **TF-free**: ``keras_weight_map`` (a ``state_dict`` -> Keras layer name ->
  weights in ``set_weights()`` order, the dense layers named as the
  reference names them, in graph order).
- **TF**: ``build_reference_keras_model``, ``export_keras_kws_model``,
  ``export_and_save``, ``convert_checkpoint_and_save``; they import
  ``tensorflow`` inside.

The trunk's input prefix must be Keras' default Rescaling(1/255) and an
identity Normalization (``input_scale`` 1/255, ``input_bias`` 0): any other
cannot be held by the stock ``keras.applications`` prefix, and is refused.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .efficientnet import EfficientNet
from .import_tf import (
    BLOCK_LAYERS,
    EMBEDDING_DENSE,
    EMBEDDING_TAIL,
    TRANSFER_TAIL,
    _tensorflow,
    iter_leaf_layers,
)

_PORT_TO_KERAS = {v: k for k, v in BLOCK_LAYERS.items()}
# the reference's dense layers in a fresh Keras session, in graph order
REFERENCE_DENSE_NAMES = ("dense", "dense_1", "dense_2", "dense_3", "dense_4")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _keras_layer(module_path: str) -> str:
    """"trunk.block2a.dw_conv" -> "block2a_dwconv"; "trunk.stem.bn" ->
    "stem_bn"."""
    _, block, name = module_path.split(".")
    if block in ("stem", "top"):
        return f"{block}_{name}"
    return f"{block}_{_PORT_TO_KERAS[name]}"


def keras_weight_map(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The TF-free core: a ``KWSEmbeddingModel`` / ``KWSTransferModel``
    ``state_dict`` -> dict(by_name: Keras layer name -> weights in
    ``set_weights()`` order, dense_order: the dense layers' names in graph
    order, kind, num_outputs). ``import_tf.import_weight_map(by_name,
    dense_order)`` inverts it."""
    sd = dict(state_dict)
    if "transfer_head.out.bias" in sd:
        kind, dense_paths = "transfer", EMBEDDING_DENSE + TRANSFER_TAIL
    elif "classifier.bias" in sd:
        kind, dense_paths = "embedding", EMBEDDING_DENSE + EMBEDDING_TAIL
    else:
        raise ValueError("not a KWS model's state_dict: no classifier and no transfer head")
    by_name: Dict[str, list] = {}
    modules = dict.fromkeys(k.rsplit(".", 1)[0] for k in sd if k.startswith("trunk."))
    for path in modules:
        name = _keras_layer(path)
        if path.endswith("bn"):
            if f"{path}.running_mean" not in sd:
                raise ValueError(f"{path}: a BatchNorm without its running statistics")
            by_name[name] = [_np(sd[f"{path}.{n}"]) for n in ("weight", "bias", "running_mean", "running_var")]
            continue
        w = _np(sd[f"{path}.weight"])
        if path.endswith("dw_conv"):  # (C, 1, H, W) -> Keras DepthwiseConv2D (H, W, C, 1)
            weights = [np.ascontiguousarray(w.transpose(2, 3, 0, 1))]
        else:  # (Cout, Cin, H, W) -> (H, W, Cin, Cout)
            weights = [np.ascontiguousarray(w.transpose(2, 3, 1, 0))]
        if f"{path}.bias" in sd:
            weights.append(_np(sd[f"{path}.bias"]))
        by_name[name] = weights
    dense_order = list(REFERENCE_DENSE_NAMES[: len(dense_paths)])
    for name, path in zip(dense_order, dense_paths):
        by_name[name] = [np.ascontiguousarray(_np(sd[f"{path}.weight"]).T), _np(sd[f"{path}.bias"])]
    num_outputs = int(sd[f"{dense_paths[-1]}.bias"].shape[0])
    return {"by_name": by_name, "dense_order": dense_order, "kind": kind, "num_outputs": num_outputs}


# -- the TF half ---------------------------------------------------------------


def build_reference_keras_model(num_labels: int, kind: str = "embedding", transfer_categories: int = 3):
    """The reference architectures with the reference's layer names.

    kind="embedding": EfficientNetB0(include_top=False, weights=None) + GAP
    + Dense1024 relu x2 + Dense192 selu ("dense_2") + Dense num_labels
    (train_monolingual_embedding.py:81-100; dense..dense_3, as the
    reference's auto-naming gives them in a fresh session).
    kind="transfer": the same trunk and head truncated at "dense_2" + Dense
    18 tanh + Dense softmax (transfer_learning.py:38-53)."""
    tf = _tensorflow()
    inputs = tf.keras.Input((49, 40, 1))
    trunk = tf.keras.applications.EfficientNetB0(include_top=False, weights=None, input_tensor=inputs)
    x = tf.keras.layers.GlobalAveragePooling2D()(trunk.output)
    x = tf.keras.layers.Dense(1024, activation="relu", name="dense")(x)
    x = tf.keras.layers.Dense(1024, activation="relu", name="dense_1")(x)
    x = tf.keras.layers.Dense(192, activation="selu", kernel_initializer="lecun_normal", name="dense_2")(x)
    if kind == "embedding":
        out = tf.keras.layers.Dense(num_labels, name="dense_3")(x)
    elif kind == "transfer":
        x = tf.keras.layers.Dense(18, activation="tanh", name="dense_3")(x)
        out = tf.keras.layers.Dense(transfer_categories, activation="softmax", name="dense_4")(x)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return tf.keras.Model(inputs, out)


def export_keras_kws_model(
    state_dict: Mapping[str, torch.Tensor],
    input_scale: float = 1.0 / 255.0,
    input_bias: float = 0.0,
    keras_model=None,
):
    """A port model's ``state_dict`` -> a reference-architecture Keras model
    with the same weights. ``keras_model``: a destination built beforehand
    (with the reference's trunk layer names; its dense layers are filled in
    graph order), else one from ``build_reference_keras_model``. Every
    weighted Keras layer must find its tensors, and every tensor its layer
    (a trunk of another width or depth is refused)."""
    if not (np.isclose(input_scale, 1.0 / 255.0) and np.isclose(input_bias, 0.0)):
        raise ValueError(
            "the stock Keras EfficientNetB0 prefix is Rescaling(1/255) + identity Normalization; cannot "
            f"represent input_scale={input_scale}, input_bias={input_bias}"
        )
    m = keras_weight_map(state_dict)
    if keras_model is None:
        keras_model = build_reference_keras_model(
            m["num_outputs"] if m["kind"] == "embedding" else 761, kind=m["kind"],
            transfer_categories=m["num_outputs"],
        )
    by_name, dense = m["by_name"], iter(m["dense_order"])
    used = set()
    for layer in iter_leaf_layers(keras_model):
        if layer.__class__.__name__ == "Dense":
            name = next(dense, None)
            if name is None:
                raise ValueError(f"the Keras model has more dense layers than {m['dense_order']}")
        elif not layer.get_weights() or layer.name.startswith(("normalization", "rescaling")):
            continue  # the (default) input prefix carries no learned state
        else:
            name = layer.name
            if name not in by_name:
                raise ValueError(f"no weights for the Keras layer {name!r} ({layer.__class__.__name__})")
        layer.set_weights(by_name[name])
        used.add(name)
    unused = sorted(set(by_name) - used)
    if unused:
        raise ValueError(f"weights with no layer in the Keras model: {unused[:8]}")
    return keras_model


def export_and_save(
    state_dict: Mapping[str, torch.Tensor],
    dest,
    input_scale: float = 1.0 / 255.0,
    input_bias: float = 0.0,
) -> None:
    """Export and write: ``.keras`` / ``.h5`` by ``model.save`` (loadable by
    ``tf.keras.models.load_model``, as the reference's ``base_model_path``),
    anything else by Keras 3's ``model.export`` (an inference SavedModel
    directory)."""
    model = export_keras_kws_model(state_dict, input_scale=input_scale, input_bias=input_bias)
    if str(dest).endswith((".keras", ".h5")):
        model.save(dest)
    else:
        model.export(dest)


def convert_checkpoint_and_save(ckpt_path, dest, device="cuda") -> None:
    """The port's checkpoint (as ``train``, ``pretrain`` or ``import-tf``
    write it) -> a Keras artifact; the inverse of
    ``import_tf.convert_and_save``. The trunk's input prefix is the one
    ``checkpoints.sized_trunk`` rebuilds. Refuses, before any TensorFlow
    call, a trunk that is not an EfficientNet (the Keras architecture
    written is EfficientNetB0's) and a checkpoint without the trunk's BN
    running statistics: a working Keras model needs them."""
    from ..train.checkpoints import load_model, sized_trunk

    state, meta = load_model(ckpt_path, device)
    with torch.device("meta"):
        trunk = sized_trunk(meta)
    if not isinstance(trunk, EfficientNet):
        raise ValueError(
            f"checkpoint {ckpt_path} holds a {type(trunk).__name__} trunk: the Keras model export writes is "
            "EfficientNetB0's, so only an EfficientNet trunk is exported"
        )
    if not any(k.endswith(".running_mean") for k in state):
        raise ValueError(
            f"checkpoint {ckpt_path} has no BN running statistics: the EfficientNet trunk needs them to build a "
            "working Keras model (save the model's whole state_dict)"
        )
    export_and_save(state, dest, input_scale=trunk.input_scale, input_bias=trunk.input_bias)
