"""The port's graft entry points (``multilingual_kws_tpu_torch/graft_entry.py``)
against the JAX package's (``__graft_entry__.py``), on the CPU.

``entry()``: the frontend + full-width B0 761-way forward, with the JAX
entry's weights carried across by ``models/convert.py`` (BN statistics and
parameters moved off their init, as tests/test_torch_model.py does, and the
stem's kernel scaled by 255, which undoes Keras' 1/255 input scale: without
it every row's logits agree to 1e-6 whatever the audio, and the comparison
would be weak), on seeded audio. The JAX side runs its plain frontend
(no Pallas on the CPU). Tolerance: tests/test_torch_model.py's, logits
rtol 1e-5 with atol 1e-5: both sides compute in float32 and differ only in
the order of the float32 sums in convolutions and matmuls.

``dryrun_multichip(2)`` over gloo: two spawned ranks, each wait bounded
(the process group's 60 s, the join's 180 s, as tests/test_torch_parallel.py
bounds them); its four lines, and its step's loss against one process
taking the same step on the same global batch (rtol 1e-5: BN and
drop-connect span the global batch).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from multilingual_kws_tpu_torch import graft_entry
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.train.steps import flat_adam, make_pretrain_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LINES = [
    r"dryrun_multichip\(2\): step ok, loss=\d+\.\d{4}, eval_correct=\d+",
    r"dryrun_multichip\(2\): resident fused step ok, loss=\d+\.\d{4}",
    r"dryrun_multichip\(2\): resident scanned epoch ok \(2 steps\), last loss=\d+\.\d{4}",
    r"dryrun_multichip\(2\): window-sharded streaming ok, \d+ windows, \d+ detections @0\.5",
]


def test_entry_matches_the_jax_entry():
    forward_jax, (params, batch_stats, batch) = jax_entry.entry()
    assert batch.shape == (8, 16000)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(lambda a: (np.asarray(a) + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32),
                                   batch_stats)
    params = jax.tree_util.tree_map(lambda a: (np.asarray(a) * rng.uniform(0.8, 1.5, a.shape)).astype(np.float32),
                                    params)
    params["trunk"]["stem"]["conv"]["kernel"] = params["trunk"]["stem"]["conv"]["kernel"] * np.float32(255)
    audio = np.random.default_rng(2).normal(0, 0.2, (8, 16000)).astype(np.float32).clip(-1, 1)
    want = np.asarray(jax.jit(forward_jax)(params, stats, jnp.asarray(audio)))

    forward, (example,) = graft_entry.entry(device="cpu")
    assert tuple(example.shape) == (8, 16000) and example.dtype == torch.float32 and not forward.training
    forward.model.load_state_dict(flax_to_state_dict({"params": params, "batch_stats": stats}), strict=True)
    with torch.no_grad():
        got = forward(torch.from_numpy(audio)).numpy()
        assert tuple(forward(example).shape) == (8, 761)
    assert got.shape == want.shape == (8, 761)
    assert np.ptp(want, axis=0).max() > 1e-3  # the rows differ: a real comparison
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def two_ranks():
    return graft_entry.dryrun_multichip(2, device="cpu")


def test_dryrun_prints_the_four_lines(two_ranks):
    assert len(two_ranks["lines"]) == 4
    for line, pattern in zip(two_ranks["lines"], LINES):
        assert re.fullmatch(pattern, line), line
    assert two_ranks["eval_correct"] == 2.0  # every row is label 0, as in the JAX dry run
    assert two_ranks["windows"] == 100 and len(two_ranks["epoch_losses"]) == 2
    assert np.isfinite([two_ranks["step_loss"], two_ranks["fused_loss"], *two_ranks["epoch_losses"]]).all()


def test_two_rank_step_matches_one_process(two_ranks):
    model = graft_entry.dryrun_embedding_model(full_size=False)
    step, _ = make_pretrain_step(model, flat_adam(model.parameters(), 1e-3), None)
    specs, labels = graft_entry.dryrun_batch(2)
    want = float(step(specs, labels, torch.Generator().manual_seed(1))["loss"])
    np.testing.assert_allclose(two_ranks["step_loss"], want, rtol=1e-5)
