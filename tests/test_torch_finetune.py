"""The port's few-shot fine-tune (train/steps.py, train/finetune.py,
train/evaluate.py) against the JAX package, on a tiny trunk whose weights
are converted from the Flax ones (models/convert.py).

Tolerances, and why:

- loss and gradients (rtol 1e-4, atol 1e-4 of the tensor's largest
  gradient): both sides run float32 on the CPU with the same weights and
  inputs and differ only in the order of float32 sums in convolutions,
  matmuls and their transposes (oneDNN against XLA:CPU), a few ulps per
  layer, which the backward pass carries to the smallest gradient entries;
- Adam against optax.adam(eps=1e-7) given identical gradients (atol 1e-4 of
  the learning rate, over 5 steps): the same formula, with the bias
  corrections applied in another order (a few float32 ulps per update);
- calibrated BN statistics (rtol 1e-3, atol 1e-5): the JAX package recovers
  each batch moment from Flax's momentum update, (new - 0.99 old) / 0.01,
  which multiplies the float32 rounding of the update by 100, and takes the
  variance as E[x^2] - E[x]^2;
- eval metrics (rtol 1e-5): one forward pass, as in tests/test_torch_model.py;
- frozen tensors: bitwise.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import make_corpus, tiny_transfer_model
from multilingual_kws_tpu.data.dataset import AudioDataset as JaxAudioDataset
from multilingual_kws_tpu.models.kws_model import make_transfer_model as flax_transfer_model
from multilingual_kws_tpu.settings import standard_microspeech_model_settings as jax_settings
from multilingual_kws_tpu.train import finetune as jax_finetune
from multilingual_kws_tpu.train import steps as jax_steps
from multilingual_kws_tpu_torch.data.dataset import AudioDataset
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import BlockArgs, EfficientNet, drop_connect
from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel, lecun_init_, make_transfer_model
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.train import steps
from multilingual_kws_tpu_torch.train.evaluate import evaluate_files_multiclass, evaluate_files_single_target
from multilingual_kws_tpu_torch.train.finetune import (
    _head_and_top,
    _head_only,
    evaluate_dataset,
    transfer_learn,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PHASES = {"head_only": (_head_only, jax_finetune._head_only), "head_and_top": (_head_and_top, jax_finetune._head_and_top)}


def _tiny_trunk(**kw):
    """tests/helpers.py's tiny config, in the port."""
    return EfficientNet(
        width_coefficient=0.25,
        depth_coefficient=0.4,
        blocks=(
            BlockArgs(3, 1, 32, 16, 1, 1),
            BlockArgs(3, 1, 16, 24, 6, 2),
            BlockArgs(5, 1, 24, 40, 6, 2),
        ),
        **kw,
    )


def _inputs(n=8, seed=0):
    return np.random.default_rng(seed).uniform(0, 26, (n, 49, 40, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def flax_pair():
    """A tiny Flax transfer model (input scale 1, no drop-connect) with BN
    statistics and weights moved off their init, and the port's model
    holding the same weights."""
    fm = tiny_transfer_model(input_scale=1.0, drop_connect_rate=0.0)
    x = _inputs()
    v = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(1)
    v = {
        "params": jax.tree_util.tree_map(lambda a: (a * rng.uniform(0.8, 1.5, a.shape)).astype(np.float32), v["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda a: (a + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32), v["batch_stats"]
        ),
    }
    return fm, v


def _port_model(v, **trunk_kw):
    model = KWSTransferModel(_tiny_trunk(input_scale=1.0, drop_connect_rate=0.0, **trunk_kw), 3).eval()
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    return model


def _mask_tree(params, pred):
    """The sub-tree of ``params`` whose paths ``pred`` accepts."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(p.key for p in path)
        if pred(keys):
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = leaf
    return out


@pytest.mark.parametrize("phase", list(PHASES))
def test_step_loss_and_gradients_match_jax(flax_pair, phase):
    fm, v = flax_pair
    port_pred, jax_pred = PHASES[phase]
    x = _inputs(seed=2)
    labels = np.array([0, 1, 2, 2, 1, 0, 2, 1], np.int32)

    def loss_fn(params):
        probs = fm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x), train=False)
        return jax_steps.sparse_ce_from_probs(probs, jnp.asarray(labels)).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    want = flax_to_state_dict({"params": _mask_tree(jax.tree_util.tree_map(np.asarray, grads), jax_pred)})

    model = _port_model(v)
    step, _, _ = steps.make_finetune_step(model, 1e-3, port_pred)
    metrics = step(torch.from_numpy(x), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert set(got) == set(want) and len(got) > 0
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_adam_tracks_optax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(0, 1, (18, 3)).astype(np.float32), "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, s, v.shape).astype(np.float32) for k, v in p0.items()} for s in (1, 1e-3, 10, 1e-6, 0.1)]
    lr = 1e-2
    tx = jax_steps.adam(lr)
    params, state = jax.tree_util.tree_map(jnp.asarray, p0), None
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = steps.adam(list(tparams.values()), lr)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=0, atol=1e-4 * lr)
    assert opt.defaults["eps"] == 1e-7


@pytest.mark.parametrize("phase", list(PHASES))
def test_frozen_tensors_unchanged(flax_pair, phase):
    _, v = flax_pair
    model = _port_model(v)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    pred = PHASES[phase][0]
    step, _, _ = steps.make_finetune_step(model, 1e-2, pred)
    for seed in range(3):
        step(torch.from_numpy(_inputs(seed=seed)), torch.tensor([0, 1, 2, 2, 1, 0, 2, 1]))
    assert not model.training
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    after = model.state_dict()
    for k, t in after.items():
        if k in trainable:
            assert not torch.equal(t, before[k]), f"{k} did not train"
        else:
            assert torch.equal(t, before[k]), f"{k} changed"
    if phase == "head_and_top":
        assert "trunk.top.conv.weight" in trainable
        assert not any(".bn." in k or k.endswith("_bn.weight") for k in trainable)


@pytest.mark.parametrize("phase", list(PHASES))
def test_trainable_sets_map_onto_jax(phase):
    """At full B0 width: the parameters each phase trains are the Flax
    parameters the JAX predicate trains, one to one."""
    port_pred, jax_pred = PHASES[phase]
    shapes = jax.eval_shape(lambda: flax_transfer_model().init(jax.random.PRNGKey(0), jnp.zeros((1, 49, 40, 1))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    want = set(flax_to_state_dict({"params": _mask_tree(zeros, jax_pred)}))
    got = set(steps.set_trainable(make_transfer_model(device="cpu"), port_pred))
    assert got == want
    if phase == "head_and_top":
        assert {"trunk.top.conv.weight", "embedding_head.dense_2.bias"} <= got


def test_calibrate_batch_stats_matches_jax(flax_pair):
    fm, v = flax_pair
    batches = [_inputs(seed=s) for s in (3, 4)]
    want = jax_steps.calibrate_batch_stats(fm, v, [jnp.asarray(b) for b in batches])
    want = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, want["batch_stats"])})
    model = _port_model(v)
    params_before = {n: p.clone() for n, p in model.named_parameters()}
    steps.calibrate_batch_stats(model, [torch.from_numpy(b) for b in batches])
    assert not model.training
    got = model.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5, err_msg=k)
    for n, p in model.named_parameters():
        assert torch.equal(p, params_before[n])


def test_train_mode_drop_connect():
    """Per sample, drop-connect keeps the branch with probability 1 - rate
    and scales it by 1/(1 - rate) (Flax Dropout with broadcast_dims
    (1, 2, 3)); the draws come from the generator given."""
    x = torch.ones((4000, 2, 3, 3))
    y = drop_connect(x, 0.25, torch.Generator().manual_seed(0))
    per_sample = y.flatten(1)
    assert bool((per_sample == per_sample[:, :1]).all())
    assert set(torch.unique(y).tolist()) == {0.0, (torch.tensor(1.0) / 0.75).item()}
    assert 0.22 < float((per_sample[:, 0] == 0).float().mean()) < 0.28
    assert torch.equal(y, drop_connect(x, 0.25, torch.Generator().manual_seed(0)))
    trunk = _tiny_trunk()
    rates = [getattr(trunk, n).drop_rate for n in trunk.block_names]
    assert rates == [0.2 * i / 3 for i in range(3)]  # JAX: rate * bidx / total_blocks
    two = EfficientNet(width_coefficient=0.25, blocks=(BlockArgs(3, 2, 32, 16, 1, 1),))
    assert two.block1b.residual and two.block1b.drop_rate == 0.1
    model = KWSTransferModel(two, 3).train()
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros((2, 49, 40, 1)))
    gen = torch.Generator().manual_seed(1)
    assert torch.isfinite(model(torch.ones((2, 49, 40, 1)), drop_generator=gen)).all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), clips_per_word=12)


def test_evaluate_dataset_matches_jax(flax_pair, corpus):
    fm, v = flax_pair
    files = corpus["alpha"][5:] + corpus["bravo"][:3]
    kw = dict(commands=["alpha"], background_data_dir=corpus["bg_dir"], unknown_files=corpus["unknown_files"], seed=0)
    init_state, _, jax_eval, _ = jax_steps.make_finetune_step(fm, 1e-3, jax_finetune._head_only)
    want = jax_finetune.evaluate_dataset(
        jax_eval, init_state(v), JaxAudioDataset(model_settings=jax_settings(3), **kw), files, 4
    )
    model = _port_model(v)
    _, evaluate, _ = steps.make_finetune_step(model, 1e-3, _head_only)
    got = evaluate_dataset(
        evaluate, AudioDataset(model_settings=standard_microspeech_model_settings(3), device="cpu", **kw), files, 4
    )
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-6)


def _tiny_model(seed=0):
    return lecun_init_(KWSTransferModel(_tiny_trunk(), 3), seed)


def test_five_shot_transfer_learn_on_cpu(corpus, tmp_path):
    """tests/test_finetune_e2e.py's 5-shot run of the JAX package, in the
    port: 2 epochs of 16 steps at batch 16, then the evaluation helpers."""
    val = corpus["alpha"][5:]
    log = tmp_path / "log.csv"
    result = transfer_learn(
        target="alpha", train_files=corpus["alpha"][:5], val_files=val,
        unknown_files=corpus["unknown_files"], num_epochs=2, num_batches=1, batch_size=16,
        primary_lr=1e-2, bg_datadir=corpus["bg_dir"], csvlog_dest=log, seed=0, verbose=0,
        model=_tiny_model(2), device="cpu",
    )
    assert result.details["val_accuracy"] >= 0.8, result.details
    assert result.details["target"] == "alpha" and "xfer_epochs_2" in result.name
    (hist,) = result.history
    assert [len(s) for s in hist["step_loss"]] == [16, 16]
    assert np.isfinite(hist["step_loss"]).all()
    rows = list(csv.DictReader(open(log)))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    predict = result.predict_fn()
    res = evaluate_files_multiclass(val, target_id=2, predict_fn=predict, device="cpu")
    assert len(res["correct"]) / len(val) >= 0.8
    conf, preds = evaluate_files_single_target(val, 2, predict, device="cpu")
    np.testing.assert_allclose(preds.sum(1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(conf, preds[:, 2])


def test_resident_and_streaming_transfer_learn_agree(corpus):
    """Both input pipelines draw alike, so one seed trains alike."""
    def run(resident):
        return transfer_learn(
            target="alpha", train_files=corpus["alpha"][:5], val_files=corpus["alpha"][5:8],
            unknown_files=corpus["unknown_files"], num_epochs=1, batch_size=8, primary_lr=1e-2,
            bg_datadir=corpus["bg_dir"], seed=1, verbose=0, resident=resident,
            model=_tiny_model(1), device="cpu",
        )

    a, b = run(True), run(False)
    assert a.history[0]["step_loss"] == b.history[0]["step_loss"]
    for (k, t), u in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(t, u), k


def test_phase_two_from_flax_base_weights(flax_pair, corpus):
    """Base weights given as Flax trees: no calibration, the trunk is the
    converted one; phase 2 then trains the top conv and embedding head and
    leaves every BN tensor as it was."""
    _, v = flax_pair
    model = KWSTransferModel(_tiny_trunk(input_scale=1.0, drop_connect_rate=0.0), 3)
    base = flax_to_state_dict(v)
    result = transfer_learn(
        target="alpha", train_files=corpus["alpha"][:5], val_files=corpus["alpha"][5:8],
        unknown_files=corpus["unknown_files"], num_epochs=1, batch_size=8, primary_lr=1e-2,
        backprop_into_embedding=True, embedding_lr=1e-3, bg_datadir=corpus["bg_dir"], seed=2,
        verbose=0, base_params=v["params"], base_batch_stats=v["batch_stats"], model=model, device="cpu",
    )
    assert len(result.history) == 2
    sd = result.state_dict()
    for k, t in sd.items():
        if ".bn." in k or "_bn." in k:
            assert torch.equal(t, base[k]), k
        elif k.startswith("trunk.") and not k.startswith("trunk.top.conv"):
            assert torch.equal(t, base[k]), k
    assert not torch.equal(sd["trunk.top.conv.weight"], base["trunk.top.conv.weight"])
    assert not torch.equal(sd["embedding_head.dense_0.weight"], base["embedding_head.dense_0.weight"])


@pytest.mark.parametrize("kw", [dict(compute_dtype="float16")])
def test_transfer_learn_refuses_what_is_not_ported(kw):
    """The port computes in float32 or bfloat16 (tests/test_torch_bf16.py);
    other compute dtypes are refused before any work."""
    with pytest.raises(NotImplementedError):
        transfer_learn("alpha", [], [], [], device="cpu", **kw)
