"""The port's TF import and export (models/import_tf.py, models/export_tf.py
and the CLI's import-tf / export-tf) against the JAX package's and Keras.

Keras models: one random-weight embedding model of the reference's
architecture (EfficientNetB0, 1024, 1024, 192, 7 logits) and one transfer
model cut from it (the reference's surgery at dense_2, then 18 tanh and 3
softmax), built once for the file as tests/test_import_tf.py builds them, and
one SavedModel directory of the embedding model.

Tolerances, and why:

- the port's import against the JAX import, export then import, the TF-free
  round trip, the port's export against the JAX export: == (each is a copy
  or a transpose of the same float32 arrays);
- the port's outputs against Keras: atol 2e-3, rtol 1e-3, the JAX test's
  (tests/test_import_tf.py:80; TF sums its float32 convolutions in another
  order, through 16 blocks);
- the port's outputs against the Flax model on the same weights: 1e-5,
  tests/test_torch_model.py's.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from helpers import make_corpus
from multilingual_kws_tpu.models import export_tf as jax_export
from multilingual_kws_tpu.models import import_tf as jax_import
from multilingual_kws_tpu.models.efficientnet import EfficientNetB0 as JaxB0
from multilingual_kws_tpu.models.kws_model import KWSEmbeddingModel as JaxEmbedding
from multilingual_kws_tpu.models.kws_model import KWSTransferModel as JaxTransfer
from multilingual_kws_tpu_torch.api import cli
from multilingual_kws_tpu_torch.models import export_tf, import_tf
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import (
    KWSTransferModel,
    make_embedding_model,
    make_transfer_model,
    seeded_init_,
)
from multilingual_kws_tpu_torch.train import checkpoints as ck

KERAS_ATOL, KERAS_RTOL = 2e-3, 1e-3
FLAX_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tf():
    tf = pytest.importorskip("tensorflow")
    tf.config.set_visible_devices([], "GPU")
    return tf


@pytest.fixture(scope="module")
def keras_models(tf):
    """{"embedding": ..., "transfer": ...}: random-weight Keras models of the
    reference's two shapes (the transfer model shares the trunk)."""
    tf.keras.utils.set_random_seed(0)
    inputs = tf.keras.Input((49, 40, 1))
    trunk = tf.keras.applications.EfficientNetB0(include_top=False, weights=None, input_tensor=inputs)
    x = tf.keras.layers.GlobalAveragePooling2D()(trunk.output)
    x = tf.keras.layers.Dense(1024, activation="relu")(x)
    x = tf.keras.layers.Dense(1024, activation="relu")(x)
    emb = tf.keras.layers.Dense(192, activation="selu", kernel_initializer="lecun_normal")(x)
    embedding = tf.keras.Model(inputs, tf.keras.layers.Dense(7)(emb))
    x = tf.keras.layers.Dense(18, activation="tanh")(emb)
    transfer = tf.keras.Model(inputs, tf.keras.layers.Dense(3, activation="softmax")(x))
    # BN statistics away from their init, so that a lost statistic shows
    rng = np.random.default_rng(0)
    for layer in import_tf.iter_leaf_layers(embedding):
        if layer.__class__.__name__ == "BatchNormalization":
            g, b, m, v = layer.get_weights()
            layer.set_weights([g * rng.uniform(0.8, 1.2, g.shape), b + rng.normal(0, 0.05, b.shape),
                               rng.normal(0, 0.05, m.shape), rng.uniform(0.8, 1.5, v.shape)])
    return {"embedding": embedding, "transfer": transfer}


@pytest.fixture(scope="module")
def savedmodel_dir(keras_models, tmp_path_factory):
    path = tmp_path_factory.mktemp("savedmodel") / "embedding"
    keras_models["embedding"].export(str(path))
    return path


def _inputs(seed, n=3):
    return (np.random.default_rng(seed).normal(0, 8, (n, 49, 40, 1)) + 10.0).astype(np.float32)


def _port_out(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _assert_state_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["embedding", "transfer"])
def test_import_equals_the_jax_import(keras_models, kind):
    got = import_tf.import_keras_kws_model(keras_models[kind])
    want = jax_import.import_keras_kws_model(keras_models[kind])
    _assert_state_equal(got["state_dict"], flax_to_state_dict(want))
    for key in ("kind", "num_outputs", "input_scale", "input_bias"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("kind", ["embedding", "transfer"])
def test_imported_model_matches_keras_and_flax(tf, keras_models, kind):
    keras_model = keras_models[kind]
    model = import_tf.model_from_import(import_tf.import_keras_kws_model(keras_model), "cpu")
    x = _inputs(1)
    got = _port_out(model, x)
    np.testing.assert_allclose(got, keras_model(x, training=False).numpy(), atol=KERAS_ATOL, rtol=KERAS_RTOL)

    imported = jax_import.import_keras_kws_model(keras_model)
    trunk = JaxB0(input_scale=imported["input_scale"], input_bias=imported["input_bias"])
    if kind == "embedding":
        module = JaxEmbedding(num_labels=imported["num_outputs"], trunk=trunk)
    else:
        module = JaxTransfer(trunk=trunk, num_categories=imported["num_outputs"])
    variables = {"params": imported["params"], "batch_stats": imported["batch_stats"]}
    flax = np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x))
    np.testing.assert_allclose(got, flax, atol=FLAX_TOL, rtol=FLAX_TOL)
    if kind == "embedding":  # the 192-d embedding, reference layer dense_2
        with torch.no_grad():
            emb = model.embed(torch.from_numpy(x)).numpy()
        keras_emb = tf.keras.Model(keras_model.input, keras_model.layers[-2].output)
        np.testing.assert_allclose(emb, keras_emb(x, training=False).numpy(), atol=KERAS_ATOL, rtol=KERAS_RTOL)


@pytest.mark.parametrize("fmt", ["savedmodel", "keras"])
def test_import_tf_checkpoint_from_disk(keras_models, savedmodel_dir, tmp_path, fmt):
    """A SavedModel directory (the released checkpoint's format, read by
    variable name) and a .keras file (a transfer model) give the live
    import's tensors."""
    kind = "embedding" if fmt == "savedmodel" else "transfer"
    keras_model = keras_models[kind]
    path = savedmodel_dir
    if fmt == "keras":
        path = tmp_path / "transfer.keras"
        keras_model.save(str(path))
    model, meta = import_tf.import_tf_checkpoint(str(path), device="cpu")
    assert meta["kind"] == kind and meta["num_outputs"] == (7 if kind == "embedding" else 3)
    _assert_state_equal(model.state_dict(), import_tf.import_keras_kws_model(keras_model)["state_dict"])
    np.testing.assert_allclose(_port_out(model, _inputs(2)), keras_model(_inputs(2), training=False).numpy(),
                               atol=KERAS_ATOL, rtol=KERAS_RTOL)


@pytest.mark.parametrize("kind", ["embedding", "transfer"])
def test_tf_free_round_trip(kind):
    """state_dict -> Keras layer map -> state_dict, ==, with no TensorFlow."""
    model = make_embedding_model(5, device="cpu") if kind == "embedding" else make_transfer_model(device="cpu")
    sd = seeded_init_(model, 3).state_dict()
    m = export_tf.keras_weight_map(sd)
    assert m["kind"] == kind and m["num_outputs"] == (5 if kind == "embedding" else 3)
    back = import_tf.import_weight_map(m["by_name"], m["dense_order"])
    _assert_state_equal(back["state_dict"], sd)
    assert (back["input_scale"], back["input_bias"]) == (1.0 / 255.0, 0.0)


def test_an_adapted_normalization_folds_into_the_trunk_and_its_checkpoint(tmp_path):
    """A Keras Normalization with a mean and variance folds into
    input_scale / input_bias, which the checkpoint keeps and
    load_transfer_model restores."""
    m = export_tf.keras_weight_map(seeded_init_(make_transfer_model(device="cpu"), 5).state_dict())
    m["by_name"]["normalization"] = [np.array([0.5], np.float32), np.array([4.0], np.float32), np.array(9)]
    imported = import_tf.import_weight_map(m["by_name"], m["dense_order"])
    assert (imported["input_scale"], imported["input_bias"]) == (1.0 / 255.0 * 0.5, -0.25)
    model = import_tf.model_from_import(imported, "cpu")
    ck.save_model(tmp_path / "m", model, {"kind": "transfer", **ck.trunk_metadata(model.trunk)})
    loaded, _ = ck.load_transfer_model(tmp_path / "m", "cpu")
    assert (loaded.trunk.input_scale, loaded.trunk.input_bias) == (model.trunk.input_scale, model.trunk.input_bias)
    x = _inputs(7, n=2)
    np.testing.assert_array_equal(_port_out(loaded, x), _port_out(model, x))
    with pytest.raises(ValueError, match="input_scale"):
        export_tf.export_keras_kws_model(model.state_dict(), model.trunk.input_scale, model.trunk.input_bias)


@pytest.mark.parametrize("kind", ["embedding", "transfer"])
def test_export_matches_the_port_and_imports_back(tf, kind):
    model = make_embedding_model(5, device="cpu") if kind == "embedding" else make_transfer_model(device="cpu")
    sd = seeded_init_(model, 4).state_dict()
    keras_model = export_tf.export_keras_kws_model(sd)
    x = _inputs(5, n=2) / 8.0
    np.testing.assert_allclose(keras_model.predict(x, verbose=0), _port_out(model, x),
                               atol=KERAS_ATOL, rtol=KERAS_RTOL)
    back = import_tf.import_keras_kws_model(keras_model)
    assert back["kind"] == kind
    _assert_state_equal(back["state_dict"], sd)


def test_export_of_a_flax_state_equals_the_jax_export(keras_models):
    """The JAX export of Flax trees and the port's export of the same trees,
    converted, put the same weights in every Keras layer."""
    tree = jax_import.import_keras_kws_model(keras_models["transfer"])
    exported = jax_export.export_keras_kws_model(tree["params"], tree["batch_stats"])
    want, want_dense = import_tf.keras_weights_by_layer(exported)
    got = export_tf.keras_weight_map(flax_to_state_dict(tree))
    assert got["dense_order"] == want_dense
    assert set(got["by_name"]) == {k for k in want if not k.startswith("normalization")}
    for name, weights in got["by_name"].items():
        assert len(weights) == len(want[name]), name
        for a, b in zip(weights, want[name]):
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_export_refusals(tmp_path):
    sd = make_transfer_model(device="cpu").state_dict()
    with pytest.raises(ValueError, match="input_scale"):
        export_tf.export_keras_kws_model(sd, input_scale=1.0 / 127.5)
    ck.save_model(tmp_path / "params_only", {k: v for k, v in sd.items() if "running" not in k
                                             and "num_batches" not in k})
    with pytest.raises(ValueError, match="BN running statistics"):
        export_tf.convert_checkpoint_and_save(tmp_path / "params_only", tmp_path / "out.keras", device="cpu")
    narrow = KWSTransferModel(EfficientNet(depth_coefficient=0.5))
    with pytest.raises(ValueError, match="no weights for the Keras layer"):
        export_tf.export_keras_kws_model(narrow.state_dict())


def test_cli_import_train_export(keras_models, savedmodel_dir, tmp_path):
    """import-tf on a SavedModel directory -> train --embedding from it on the
    CPU -> export-tf: the Keras model matches the trained checkpoint."""
    emb = tmp_path / "embedding_ckpt"
    cli.main(["import-tf", str(savedmodel_dir), str(emb), "--device", "cpu"])
    meta = ck.load_metadata(emb)
    assert meta["kind"] == "embedding" and meta["num_outputs"] == 7 and meta["input_scale"] == 1.0 / 255.0
    state, _ = ck.load_model(emb, "cpu")
    _assert_state_equal(state, import_tf.import_keras_kws_model(keras_models["embedding"])["state_dict"])

    corpus = make_corpus(tmp_path / "corpus", clips_per_word=3)
    samples = tmp_path / "samples"
    samples.mkdir()
    for f in corpus["alpha"]:
        shutil.copy2(f, samples)
    xfer = tmp_path / "alpha_model"
    cli.main(["train", "--keyword", "alpha", "--samples-dir", str(samples), "--embedding", str(emb),
              "--unknown-words", corpus["unknown_dir"], "--background-noise", corpus["bg_dir"],
              "--output", str(xfer), "--num-epochs", "1", "--batch-size", "2", "--device", "cpu"])
    trained, tmeta = ck.load_model(xfer, "cpu")
    assert all(torch.equal(trained[k], state[k]) for k in trained if k.startswith(("trunk.", "embedding_head.")))

    dest = tmp_path / "alpha.keras"
    cli.main(["export-tf", str(xfer), str(dest), "--device", "cpu"])
    keras_model = import_tf.load_keras_model(str(dest))
    model, _ = ck.load_transfer_model(xfer, "cpu")
    x = _inputs(6, n=2)
    np.testing.assert_allclose(keras_model.predict(x, verbose=0), _port_out(model, x),
                               atol=KERAS_ATOL, rtol=KERAS_RTOL)
