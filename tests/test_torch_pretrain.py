"""The port's embedding pretraining (train/steps.py, train/pretrain.py,
models/efficientnet.BatchNorm) against the JAX package, on the tiny
embedding model of tests/helpers.py, whose weights are converted from the
Flax ones (models/convert.py). That trunk has no residual block, so
drop-connect, whose draws differ between the two packages, never applies.

Tolerances, and why:

- loss, accuracy and gradients (rtol 1e-5; gradients rtol 1e-4, atol 1e-4
  of the tensor's largest): both sides run float32 on the CPU with the same
  weights and inputs and differ only in the order of float32 sums
  (tests/test_torch_finetune.py). The bias of each block's last BN
  (``project_bn``) has an exact gradient of zero: its output reaches the
  loss only through residual adds and 1x1 convolutions into train-mode BNs,
  which remove any per-channel shift (drop-connect, which scales samples
  apart, is off in this trunk). Both sides hold float32 rounding there, and
  those are held to 1e-5 of the model's largest gradient;
- the updated BN running statistics (rtol 1e-5): each is 0.99 of the old
  value plus 0.01 of the batch moment, computed on both sides as Flax does
  (E[x^2] - E[x]^2 in float32). The old statistics start small, so the
  update weighs: torch's ``nn.BatchNorm2d``, which moves ``running_var``
  towards the unbiased variance (n / (n - 1) of it, n = 280 at the last
  layer), misses this bound;
- Adam against the JAX package's ``flat_adam`` given identical gradients
  (atol 1e-4 of the learning rate, over 5 steps), as test_adam_tracks_optax.

The pretraining parity records of the JAX package are not used here:
PARITY.md and tests/test_pretrain_parity.py cite a ``reference_bn_calibrated``
block that benchmarks/parity_pretrain.json no longer holds, and no test of
the port is held to it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_corpus, tiny_embedding_model
from multilingual_kws_tpu.models import efficientnet as jax_efficientnet
from multilingual_kws_tpu.models import kws_model as jax_kws_model
from multilingual_kws_tpu.train import steps as jax_steps
from multilingual_kws_tpu_torch.models import efficientnet
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import BlockArgs, EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import (
    KWSEmbeddingModel,
    KWSTransferModel,
    lecun_init_,
    make_embedding_model,
    transfer_params_from_embedding,
)
from multilingual_kws_tpu_torch.train import checkpoints as ck
from multilingual_kws_tpu_torch.train import steps
from multilingual_kws_tpu_torch.train.finetune import transfer_learn
from multilingual_kws_tpu_torch.train.metrics import save_history
from multilingual_kws_tpu_torch.train.pretrain import PretrainConfig, pretrain

NUM_LABELS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_trunk(**kw):
    """tests/helpers.py's tiny config, in the port."""
    return EfficientNet(
        width_coefficient=0.25,
        depth_coefficient=0.4,
        blocks=(BlockArgs(3, 1, 32, 16, 1, 1), BlockArgs(3, 1, 16, 24, 6, 2), BlockArgs(5, 1, 24, 40, 6, 2)),
        **kw,
    )


def _inputs(n=8, seed=0):
    return np.random.default_rng(seed).normal(120, 80, (n, 49, 40, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def flax_pair():
    """The tiny Flax embedding model with weights moved off their init and
    small BN running statistics, and the same weights as a ``state_dict``."""
    fm = tiny_embedding_model(num_labels=NUM_LABELS)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.asarray(_inputs(1))))
    rng = np.random.default_rng(1)
    v = {
        "params": jax.tree_util.tree_map(lambda a: (a * rng.uniform(0.8, 1.5, a.shape)).astype(np.float32), v["params"]),
        "batch_stats": jax.tree_util.tree_map(lambda a: rng.uniform(0.01, 0.05, a.shape).astype(np.float32),
                                              v["batch_stats"]),
    }
    return fm, v


def _port_model(v):
    model = KWSEmbeddingModel(NUM_LABELS, _tiny_trunk())
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    return model


def test_pretrain_step_matches_jax(flax_pair):
    fm, v = flax_pair
    x = _inputs(seed=2)
    labels = np.array([0, 1, 2, 3, 4, 4, 1, 0], np.int32)
    lr = 1e-3

    def loss_fn(params):
        logits, mutated = fm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_steps.sparse_ce_from_logits(logits, jnp.asarray(labels)).mean()

    grads = flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(v["params"]))})
    init_state, jax_step, _ = jax_steps.make_pretrain_step(fm, jax_steps.flat_adam(lr))
    new_state, want = jax.jit(jax_step)(init_state(v), jnp.asarray(x), jnp.asarray(labels), jax.random.PRNGKey(0))
    want_stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, new_state.batch_stats)})

    model = _port_model(v)
    step, evaluate = steps.make_pretrain_step(model, steps.flat_adam(model.parameters(), lr))
    got = step(torch.from_numpy(x), torch.from_numpy(labels).long(), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["accuracy"]), float(want["accuracy"]), rtol=1e-5)
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    zero = {f"trunk.{b}.project_bn.bias" for b in model.trunk.block_names}
    largest = max(float(g.abs().max()) for g in grads.values())
    for name, p in params.items():
        w = grads[name].numpy()
        if name in zero:
            assert max(np.abs(w).max(), float(p.grad.abs().max())) < 1e-5 * largest, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)
    sd = model.state_dict()
    names = [k for k in want_stats if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), want_stats[k].numpy(), rtol=1e-5, err_msg=k)
    # evaluate: eval mode on the running statistics, as the JAX evaluate
    _, _, jax_eval = jax_steps.make_pretrain_step(fm, jax_steps.flat_adam(lr))
    want_eval = jax.jit(jax_eval)(new_state, jnp.asarray(x), jnp.asarray(labels))
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats})))
    got_eval = evaluate(torch.from_numpy(x), torch.from_numpy(labels).long())
    assert not model.training
    np.testing.assert_allclose(float(got_eval["loss"]), float(want_eval["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got_eval["accuracy"]), float(want_eval["accuracy"]), rtol=1e-5)


def test_flat_adam_tracks_jax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(0, 1, (18, 3)).astype(np.float32), "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, s, v.shape).astype(np.float32) for k, v in p0.items()} for s in (1, 1e-3, 10, 1e-6, 0.1)]
    lr = 1e-2
    tx = jax_steps.flat_adam(lr)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = steps.flat_adam(list(tparams.values()), lr)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=0, atol=1e-4 * lr)
    assert opt.defaults["eps"] == 1e-7 and opt.defaults["foreach"]


def test_sparse_ce_from_logits_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(0, 8, (64, 761))).astype(np.float32)
    labels = rng.integers(0, 761, 64).astype(np.int32)
    want = np.asarray(jax_steps.sparse_ce_from_logits(jnp.asarray(logits), jnp.asarray(labels)))
    got = steps.sparse_ce_from_logits(torch.from_numpy(logits), torch.from_numpy(labels).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), clips_per_word=12)


def _config(**kw):
    kw = {"num_labels": 4, "batch_size": 16, "learning_rate": 3e-3, "silence_percentage": 10,
          "unknown_percentage": 15, "shuffle_seed": 0, "steps_per_epoch": 12, "device": "cpu", **kw}
    return PretrainConfig(**kw)


def _run(corpus, config, **kw):
    words = ["bravo", "charlie"]
    return pretrain(
        [f for w in words for f in corpus[w][:10]], [f for w in words for f in corpus[w][10:]],
        commands=words, background_data_dir=corpus["bg_dir"], unknown_files=corpus["unknown_files"],
        config=config, verbose=0, **kw,
    )


@pytest.fixture(scope="module")
def pretrained(corpus, tmp_path_factory):
    """Three epochs of the tiny model with a checkpoint, CSV log and
    history."""
    out = tmp_path_factory.mktemp("pretrain")
    config = _config(num_epochs=3, checkpoint_dir=str(out / "ckpt"), csvlog_dest=str(out / "log.csv"),
                     history_dest=str(out / "history.json"))
    model, history, dataset = _run(corpus, config, model=lecun_init_(KWSEmbeddingModel(4, _tiny_trunk()), 0))
    return out, model, history, dataset


def test_pretrain_on_cpu(pretrained, corpus):
    out, model, history, dataset = pretrained
    assert set(history) == {"loss", "accuracy", "val_loss", "val_accuracy"}
    assert all(len(v) == 3 for v in history.values())
    assert np.isfinite(history["loss"]).all() and np.isfinite(history["val_loss"]).all()
    assert history["loss"][-1] < history["loss"][0]
    assert dataset.commands == ["_silence_", "_unknown_", "bravo", "charlie"]
    assert not model.training
    assert json.loads((out / "history.json").read_text()) == history
    assert (out / "log.csv").read_text().splitlines()[0] == "epoch,loss,accuracy,val_loss,val_accuracy"
    meta = ck.load_metadata(out / "ckpt")
    best = int(np.argmax(history["val_accuracy"]))
    assert meta["kind"] == "embedding" and meta["epoch"] == best and meta["num_labels"] == 4
    assert meta["commands"] == dataset.commands and meta["val_accuracy"] == pytest.approx(history["val_accuracy"][best])
    assert (meta["width_coefficient"], meta["depth_coefficient"]) == (0.25, 0.4)
    emb = ck.load_embedding_variables(out / "ckpt", device="cpu")
    assert {k.split(".")[0] for k in emb} == {"trunk", "embedding_head"}
    assert any(k.endswith("running_var") for k in emb)
    # the checkpoint is what transfer_learn(base_model_path=...) fine-tunes from
    result = transfer_learn(
        target="alpha", train_files=corpus["alpha"][:5], val_files=corpus["alpha"][5:8],
        unknown_files=corpus["unknown_files"], num_epochs=1, batch_size=8, bg_datadir=corpus["bg_dir"], seed=0,
        verbose=0, base_model_path=out / "ckpt", model=KWSTransferModel(_tiny_trunk(), 3), device="cpu",
    )
    sd = result.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in emb.items())


def test_a_checkpoint_rebuilds_its_trunk_s_input_prefix(corpus, tmp_path):
    """``pretrain()`` records a B0 trunk's input prefix where it is not
    Keras' default (an imported Keras model's is not): the checkpoint
    rebuilds the trained model, fine-tuning from it keeps the prefix, and
    ``load_transfer_model`` rebuilds the fine-tuned model saved with its
    metadata."""
    trunk = EfficientNet(width_coefficient=0.25, depth_coefficient=0.1, input_scale=0.5, input_bias=-3.0)
    config = _config(num_epochs=1, steps_per_epoch=2, checkpoint_dir=str(tmp_path / "emb"))
    model, _, _ = _run(corpus, config, model=lecun_init_(KWSEmbeddingModel(4, trunk), 0))
    meta = ck.load_metadata(tmp_path / "emb")
    assert (meta["input_scale"], meta["input_bias"]) == (0.5, -3.0)
    rebuilt = KWSEmbeddingModel(4, ck.sized_trunk(meta))
    rebuilt.load_state_dict(ck.load_model(tmp_path / "emb", device="cpu")[0], strict=True)
    x = torch.from_numpy(_inputs(4))
    with torch.no_grad():
        assert torch.equal(rebuilt.eval()(x), model(x))
    result = transfer_learn(
        target="alpha", train_files=corpus["alpha"][:5], val_files=corpus["alpha"][5:8],
        unknown_files=corpus["unknown_files"], num_epochs=1, batch_size=8, bg_datadir=corpus["bg_dir"], seed=0,
        verbose=0, base_model_path=tmp_path / "emb", device="cpu",
    )
    assert (result.model.trunk.input_scale, result.model.trunk.input_bias) == (0.5, -3.0)
    ck.save_model(tmp_path / "alpha", result.model, {"kind": "transfer", **ck.trunk_metadata(result.model.trunk)})
    loaded, _ = ck.load_transfer_model(tmp_path / "alpha", device="cpu")
    assert (loaded.trunk.input_scale, loaded.trunk.input_bias) == (0.5, -3.0)
    with torch.no_grad():
        assert torch.equal(loaded(x), result.model.eval()(x))


def test_scanned_epoch_is_the_default_and_equals_the_step_loop(corpus):
    """``scan_epoch`` defaults to True, as in the JAX package: each resident
    epoch is one device program (``build_fused_resident_epoch``; on the card
    a CUDA graph, on the CPU the same step as a plain loop). It takes the
    same steps on the same draws as ``scan_epoch=False``: the history, every
    tensor of the model and the dataset's generator are ==."""
    assert PretrainConfig().scan_epoch is True
    runs = {}
    for scan in (True, False):
        config = _config(num_epochs=2, steps_per_epoch=3, resident_data=True, scan_epoch=scan)
        runs[scan] = _run(corpus, config, model=lecun_init_(KWSEmbeddingModel(4, _tiny_trunk()), 0))
    (ma, ha, da), (mb, hb, db) = runs[True], runs[False]
    assert ha == hb and np.isfinite(ha["loss"]).all()
    for (k, t), u in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(t, u), k
    assert torch.equal(da.gen.get_state(), db.gen.get_state())


def test_resume_continues_from_checkpoint(pretrained, corpus):
    """``resume_params`` (a port state_dict) restores parameters and BN
    statistics, and training continues from them (JAX
    tests/test_pretrain_resume.py, small): the resumed first epoch's loss is
    below the cold run's first and within 1.25 times the cold run's epoch
    after the checkpointed one (the optimizer starts fresh, the draws come
    from another seed)."""
    out, _, hist_a, _ = pretrained
    state, meta = ck.load_model(out / "ckpt", device="cpu")
    model, _, _ = _run(corpus, _config(num_epochs=0), resume_params=state,
                       model=KWSEmbeddingModel(4, _tiny_trunk()))
    assert all(torch.equal(t, state[k]) for k, t in model.state_dict().items())
    _, hist_b, _ = _run(corpus, _config(num_epochs=1, shuffle_seed=1), resume_params=state,
                        model=KWSEmbeddingModel(4, _tiny_trunk()))
    assert hist_b["loss"][0] < hist_a["loss"][0]
    after = hist_a["loss"][min(meta["epoch"] + 1, len(hist_a["loss"]) - 1)]
    assert hist_b["loss"][0] <= after * 1.25, (meta["epoch"], hist_a, hist_b)


def test_save_history(tmp_path):
    h = {"loss": [1.0, 0.5], "val_accuracy": [0.25, 0.75]}
    save_history(h, tmp_path / "sub" / "h.json")
    assert json.loads((tmp_path / "sub" / "h.json").read_text()) == h


@pytest.mark.parametrize("name", ["EfficientNetB0", "EfficientNetB1", "EfficientNetB2"])
def test_trunks_carry_the_jax_parameters(name):
    """The port's B0, B1 and B2 embedding models hold the Flax models'
    parameters and BN statistics, name for name and shape for shape."""
    fm = jax_kws_model.KWSEmbeddingModel(num_labels=761, trunk=getattr(jax_efficientnet, name)())
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 49, 40, 1))))
    want = flax_to_state_dict(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes))
    port = KWSEmbeddingModel(761, getattr(efficientnet, name)())
    got = port.state_dict()
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    if name == "EfficientNetB0":
        assert set(make_embedding_model(761, device="cpu").state_dict()) == set(want)


def test_transfer_params_from_embedding():
    emb = lecun_init_(KWSEmbeddingModel(4, _tiny_trunk()), 1).state_dict()
    xfer = lecun_init_(KWSTransferModel(_tiny_trunk(), 3), 2).state_dict()
    new = transfer_params_from_embedding(emb, xfer)
    assert set(new) == set(xfer)
    for k, t in new.items():
        src = emb if k.split(".")[0] in ("trunk", "embedding_head") else xfer
        assert t is src[k], k
    with pytest.raises(KeyError):
        transfer_params_from_embedding(emb, {k: v for k, v in xfer.items() if not k.startswith("trunk.top.")})
