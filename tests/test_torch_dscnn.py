"""The port's DS-CNN (models/dscnn.py) against the JAX package's, at a small
width (filters 16, 2 blocks, batch 4), with the weights carried across from
``DSCNN.init`` by models/convert.py (biases, BN scales and statistics
randomized first, so every tensor matters).

Tolerances, and why:

- eval-mode softmax rtol 1e-5, atol 1e-6: both sides run float32 on the CPU
  with the same weights and differ only in the order of float32 sums;
- train mode with dropout off on both sides (the JAX side through
  ``flax.linen.intercept_methods``, so nothing in the JAX package changes):
  softmax as above and the updated BN statistics rtol 1e-5, against the JAX
  package in float32; gradients rtol 1e-4 with atol 1e-4 of each tensor's
  largest (the port's other gradient tests' bound), against the JAX package
  run in float64 (``jax.enable_x64``). On this input the four rows' softmax
  barely differ, so train-mode BN's backward (which subtracts the batch's
  mean gradient) cancels most of each gradient, and the float32 sums'
  rounding is magnified: the JAX package's own float32 gradients on XLA:CPU
  are up to 1.6e-2 of a tensor's largest away from its float64 ones, the
  port's float32 ones (torch's CPU sums) within 1.2e-5 of them (the test
  prints both). Each conv
  bias feeds a train-mode BN, which removes any per-channel shift, so its
  exact gradient is zero: both sides hold float32 rounding there, held to
  1e-5 of the model's largest gradient (as tests/test_torch_pretrain.py
  holds ``project_bn.bias``);
- ``dscnn_optimizer`` against optax's chain from the same gradients:
  parameters rtol 1e-6 (one float32 rounding per operation, the same
  operations);
- the schedule's values are ``==`` as float32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multilingual_kws_tpu.models import dscnn as jax_dscnn
from multilingual_kws_tpu_torch.models import dscnn
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict

B, LABELS, FILTERS, BLOCKS = 4, 3, 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and small ops then spend their time in
    thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(seed=0):
    model = jax_dscnn.DSCNN(num_labels=LABELS, filters=FILTERS, num_blocks=BLOCKS)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 49, 40, 1)), train=False)
    )
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "bias":
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return leaf

    return model, jax.tree_util.tree_map_with_path(perturb, variables)


def _port(variables):
    m = dscnn.DSCNN(LABELS, filters=FILTERS, num_blocks=BLOCKS, device="cpu")
    m.load_state_dict(flax_to_state_dict(variables), strict=True)
    return m


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 26, (B, 49, 40, 1)).astype(np.float32)
    y = rng.integers(0, LABELS, B)
    return x, y


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def test_shapes_and_padding():
    m = dscnn.DSCNN(LABELS, filters=FILTERS, num_blocks=BLOCKS, device="cpu").eval()
    assert dscnn.same_pad(49, 10, 2) == (4, 5) and dscnn.same_pad(40, 4, 2) == (1, 1)
    p = m(torch.zeros(2, 49, 40, 1))
    assert tuple(p.shape) == (2, LABELS)
    np.testing.assert_allclose(p.sum(-1).detach().numpy(), 1.0, atol=1e-6)


def test_eval_softmax_matches_jax():
    model, variables = _variables()
    x, _ = _inputs()
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port(variables).eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_train_mode_forward_stats_and_gradients_match_jax():
    model, variables = _variables(seed=2)
    x, y = _inputs(seed=3)

    def loss_fn(params, x, batch_stats):
        with fnn.intercept_methods(_no_dropout):
            p, mut = model.apply({"params": params, "batch_stats": batch_stats}, jnp.asarray(x),
                                 train=True, mutable=["batch_stats"])
        return -jnp.log(p[jnp.arange(B), y]).mean(), (p, mut)

    (loss, (probs, mut)), grads32 = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], x, variables["batch_stats"])
    with jax.enable_x64(True):
        as64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        grads = jax.grad(lambda p: loss_fn(p, x.astype(np.float64), as64(variables["batch_stats"]))[0])(
            as64(variables["params"]))
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)
    m = _port(variables).train()
    m.stem_drop.rate = m.head_drop.rate = 0.0
    p = m(torch.from_numpy(x))
    got_loss = -torch.log(p[torch.arange(B), torch.from_numpy(y)]).mean()
    got_loss.backward()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(probs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    want_stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, mut["batch_stats"])})
    sd = m.state_dict()
    for k, w in want_stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-5, err_msg=k)
    want_grads = flax_to_state_dict({"params": grads})
    named = dict(m.named_parameters())
    assert set(named) == set(want_grads)
    zero = {"stem.bias"} | {f"{b}.{c}.bias" for b in m.block_names for c in ("dw", "pw")}
    largest = max(float(w.abs().max()) for w in want_grads.values())
    jax32 = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads32)})
    gap = {side: max(float((g[k] - w).abs().max() / w.abs().max()) for k, w in want_grads.items() if k not in zero)
           for side, g in (("JAX float32", jax32), ("port float32", {k: p.grad for k, p in named.items()}))}
    print(f"gradients against the JAX package in float64, of each tensor's largest: {gap}")
    for k, w in want_grads.items():
        w = w.numpy()
        if k in zero:
            assert max(np.abs(w).max(), float(named[k].grad.abs().max())) < 1e-5 * largest, k
            continue
        np.testing.assert_allclose(named[k].grad.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("rate", [0.2, 0.4])
def test_dropout_masks_from_a_generator(rate):
    drop = dscnn.Dropout(rate).train()
    x = torch.rand(64, 16, 25, 20) + 0.5
    out = drop(x, torch.Generator().manual_seed(0))
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / (1 - rate), rtol=0, atol=0)
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    # the same generator state gives the same mask; the global RNG is not used
    torch.manual_seed(123)
    again = drop(x, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="dropout_generator"):
        drop(x)
    assert torch.equal(drop.eval()(x), x)


def test_model_dropout_draws_only_from_the_generator():
    m = dscnn.DSCNN(LABELS, filters=FILTERS, num_blocks=BLOCKS, device="cpu").train()
    x = torch.from_numpy(_inputs()[0])
    a = m(x, dropout_generator=torch.Generator().manual_seed(4))
    b = m(x, dropout_generator=torch.Generator().manual_seed(4))
    c = m(x, dropout_generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("steps,steps_per_epoch", [(3, 1), (14, 1), (5, 2)])
def test_optimizer_matches_optax(steps, steps_per_epoch):
    """From the same gradients each step: 3 updates crossing epoch
    boundaries; 14 crossing the learning rate's first switch (epoch 12)."""
    rng = np.random.default_rng(7)
    params = {"w": rng.normal(0, 0.3, (16, 8)).astype(np.float32), "b": rng.normal(0, 0.1, 8).astype(np.float32)}
    tx = jax_dscnn.dscnn_optimizer(steps_per_epoch=steps_per_epoch)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = dscnn.dscnn_optimizer(steps_per_epoch=steps_per_epoch)(list(tp.values()))
    for i in range(steps):
        grads = {k: rng.normal(0, 1.0, v.shape).astype(np.float32) for k, v in params.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    assert opt.count == steps
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, err_msg=k)


def test_lr_schedule_values_equal_jax():
    want, got = jax_dscnn.dscnn_lr_schedule(), dscnn.dscnn_lr_schedule()
    for epoch in (0, 11, 12, 23, 24, 35, 36, 100):
        assert np.float32(got(epoch)) == np.asarray(want(epoch), np.float32), epoch
    opt = dscnn.dscnn_optimizer(steps_per_epoch=16)([torch.nn.Parameter(torch.zeros(1))])
    for step, lr in ((0, 5e-4), (12 * 16 - 1, 5e-4), (12 * 16, 1e-4), (24 * 16, 2e-5), (36 * 16, 1e-5)):
        opt.count = step
        assert opt.lr() == lr, step


def test_train_batchnorm_computes_in_at_least_float32():
    """Flax's BatchNorm promotes its statistics to at least float32: float64
    input stays float64 (the float64 reference of chip_smoke.dscnn_gate),
    float32 and bfloat16 input compute in float32."""
    from multilingual_kws_tpu_torch.models.efficientnet import BatchNorm

    x = torch.from_numpy(np.random.default_rng(8).normal(3.0, 0.01, (4, 3, 5, 5)))
    bn64 = BatchNorm(3, eps=dscnn.BN_EPS).double().train()
    y64 = bn64(x)
    assert y64.dtype == torch.float64
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    want = (x - mean[:, None, None]) / torch.sqrt(var + dscnn.BN_EPS)[:, None, None]
    torch.testing.assert_close(y64.detach(), want, rtol=1e-9, atol=1e-9)
    y32 = BatchNorm(3, eps=dscnn.BN_EPS).train()(x.float())
    assert y32.dtype == torch.float32
    assert float((y32.detach().double() - want).abs().max()) > 1e-9  # float32 moments lose digits on this input


def test_float32_gradients_within_the_chip_gate_bound(tmp_path):
    """The error model behind ``chip_smoke.dscnn_gate``'s float32 bound: at
    the reference's width, from the seeded init, on a training batch of the
    chip run's corpus (``chip_smoke.synth_corpus`` through
    ``AudioDataset.train_batches`` on the CPU), the float32 gradients below
    the global pooling lie well away from the float64 ones (train-mode BN's
    backward and the conv weight sums cancel), and inside the gate's bound
    with a margin of 2; the head's (after the last BN) hold 1e-5."""
    import chip_smoke
    from multilingual_kws_tpu_torch.data.dataset import AudioDataset
    from multilingual_kws_tpu_torch.models.kws_model import lecun_init_
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    corpus = chip_smoke.synth_corpus(tmp_path / "corpus", 5, write_wav)
    ds = AudioDataset(standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"], corpus["unknown"],
                      seed=7, device="cpu")
    specs, y = next(ds.train_batches(corpus["train"], 64, 1))
    state = lecun_init_(dscnn.DSCNN(3, device="cpu"), seed=0).state_dict()
    grads = {}
    for dtype in (torch.float64, torch.float32):
        m = dscnn.DSCNN(3, device="cpu")
        m.load_state_dict(state)
        m.to(dtype).train()
        p = m(specs.to(dtype), dropout_generator=torch.Generator().manual_seed(5))
        torch.nn.functional.nll_loss(torch.log(p.clamp(1e-7, 1 - 1e-7)), y).backward()
        grads[dtype] = {n: q.grad.double() for n, q in m.named_parameters()}
    g64, g32 = grads[torch.float64], grads[torch.float32]
    largest = max(float(g.abs().max()) for g in g64.values())
    err = {n: float((g32[n] - g).abs().max() / g.abs().max()) for n, g in g64.items()
           if float(g.abs().max()) >= 1e-4 * largest}
    head = {n: e for n, e in err.items() if n.startswith(("out.", "block4.pw_bn."))}
    below = {n: e for n, e in err.items() if n not in head}
    assert max(head.values()) < 1e-5, head
    print(f"float32 vs float64, of each tensor's largest: below the pooling {max(below.values()):.3e}, head {max(head.values()):.3e}")
    assert 1e-4 < max(below.values()) < chip_smoke.K_F32_GRAD_TOL / 2, below
