"""The port's EfficientNet transfer/embedding models against the Flax ones,
with weights carried across by ``models/convert.py``.

Tolerance: both sides compute in float32 on the CPU, with the same weights
and inputs; they differ only in the order of float32 sums inside
convolutions and matmuls (oneDNN against XLA:CPU): a few float32 ulps
per layer. The embedding and logits (up to O(10)) are held to rtol 1e-5
with atol 1e-5, the softmax to atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_transfer_model
from multilingual_kws_tpu.models.kws_model import KWSEmbeddingModel as FlaxEmbeddingModel
from multilingual_kws_tpu.models.kws_model import make_transfer_model as flax_transfer_model
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import BlockArgs, EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import (
    KWSEmbeddingModel,
    KWSTransferModel,
    make_transfer_model,
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


ATOL = 1e-5


def _tiny_trunk():
    """tests/helpers.py's tiny config, in the port (input_scale 1: with
    random weights the Keras 1/255 scale leaves the outputs nearly constant
    across inputs, which would make the comparison weak)."""
    return EfficientNet(
        input_scale=1.0,
        width_coefficient=0.25,
        depth_coefficient=0.4,
        blocks=(
            BlockArgs(3, 1, 32, 16, 1, 1),
            BlockArgs(3, 1, 16, 24, 6, 2),
            BlockArgs(5, 1, 24, 40, 6, 2),
        ),
    )


def _inputs(n=6, seed=0):
    # feature-scale inputs (micro frontend features lie in [0, ~26])
    return np.random.default_rng(seed).uniform(0, 26, (n, 49, 40, 1)).astype(np.float32)


def _flax_variables(model, x, seed=0):
    """Flax init, with BN statistics and the head moved off their init so
    every mapped tensor matters, as numpy leaves."""
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x)))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32), v["batch_stats"]
    )
    params = jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(0.8, 1.5, a.shape)).astype(np.float32), v["params"]
    )
    return {"params": params, "batch_stats": stats}


def test_transfer_model_matches_flax():
    x = _inputs()
    fm = tiny_transfer_model(input_scale=1.0)
    v = _flax_variables(fm, x)
    apply = jax.jit(lambda v, x: (fm.apply(v, x), fm.apply(v, x, method=fm.embed)))
    want_p, want_e = (np.asarray(a) for a in apply(v, jnp.asarray(x)))

    tm = KWSTransferModel(_tiny_trunk(), 3).eval()
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got_e = tm.embed(torch.from_numpy(x)).numpy()
        got_p = tm(torch.from_numpy(x)).numpy()
    assert got_p.shape == (6, 3) and got_e.shape == (6, 192)
    assert np.ptp(want_p, axis=0).max() > 1e-3  # the rows differ: a real comparison
    np.testing.assert_allclose(got_e, want_e, rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=ATOL)


def test_embedding_model_matches_flax():
    x = _inputs(seed=3)
    fm = FlaxEmbeddingModel(num_labels=5, trunk=tiny_transfer_model(input_scale=1.0).trunk)
    v = _flax_variables(fm, x, seed=3)
    want_logits, want_emb = (
        np.asarray(a)
        for a in jax.jit(lambda v, x: fm.apply(v, x, return_embedding=True))(v, jnp.asarray(x))
    )
    tm = KWSEmbeddingModel(5, _tiny_trunk()).eval()
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        logits, emb = tm(torch.from_numpy(x), return_embedding=True)
    np.testing.assert_allclose(emb.numpy(), want_emb, rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-5, atol=ATOL)


def test_full_b0_state_dict_names_and_shapes_match_flax():
    """Every tensor of the full-width B0 transfer model has its Flax
    counterpart, of the mapped shape (shapes only: no full-size compute)."""
    shapes = jax.eval_shape(
        lambda: flax_transfer_model().init(jax.random.PRNGKey(0), jnp.zeros((1, 49, 40, 1)))
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(zeros)
    model = make_transfer_model(device="cpu")
    own = model.state_dict()
    assert set(sd) == set(own)
    bad = [k for k in own if tuple(own[k].shape) != tuple(sd[k].shape)]
    assert not bad, bad
    model.load_state_dict(sd, strict=True)


def test_conversion_layouts():
    k = np.arange(3 * 5 * 1 * 8, dtype=np.float32).reshape(3, 5, 1, 8)  # depthwise (kh,kw,1,C)
    d = np.arange(6, dtype=np.float32).reshape(2, 3)  # Dense (in, out)
    sd = flax_to_state_dict({
        "params": {"a": {"dw_conv": {"kernel": k}}, "b": {"kernel": d, "bias": np.ones(3)}},
        "batch_stats": {"c": {"mean": np.zeros(2), "var": np.ones(2)}},
    })
    assert tuple(sd["a.dw_conv.weight"].shape) == (8, 1, 3, 5)
    assert sd["a.dw_conv.weight"][7, 0, 2, 4] == k[2, 4, 0, 7]
    assert torch.equal(sd["b.weight"], torch.from_numpy(d.T))
    assert set(sd) >= {"c.running_mean", "c.running_var", "c.num_batches_tracked"}
    with pytest.raises(KeyError):
        flax_to_state_dict({"params": {"x": {"embedding": np.zeros(2)}}})
