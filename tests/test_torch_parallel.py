"""Data parallelism of the port (parallel/mesh.py, the data-parallel
pretraining step, train-mode BN and drop-connect) on the CPU: two gloo
processes against one process on the same global batch, as
tests/test_parallel.py holds the JAX mesh against one device.

The two processes are spawned and meet through a file store in the test's
temporary directory (no TCP port: the suite runs in parallel workers).
Every wait has its own bound: the process group's timeout (60 s) and the
join's (180 s), after which the processes are killed and the test fails.

Tolerances: the loss and accuracy of the global batch, rtol 1e-5; the
parameters after one SGD step (lr 0.1), atol 1e-4 and rtol 1e-3, the JAX
test's bound (float32 sums taken in another order: per rank, then across);
BN running statistics rtol 1e-5 (tests/test_torch_pretrain.py; they start
in [0.01, 0.05], off zero, because some batch moments are zero exactly,
e.g. the mean of a 1x1 convolution of a train-mode BN's output, and hold
only rounding); the sharded predict against the plain one, rtol 1e-5 and atol 1e-6 (the same rows in
batches of other sizes, whose CPU convolutions may block their sums
differently).
"""

import multiprocessing
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import make_corpus
from multilingual_kws_tpu_torch.data.dataset import AudioDataset
from multilingual_kws_tpu_torch.models.efficientnet import BlockArgs, EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSEmbeddingModel, lecun_init_
from multilingual_kws_tpu_torch.parallel import mesh
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.train.steps import make_pretrain_step

GLOBAL_BATCH = 8
PREDICT_ROWS = (5, 8, 17)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    """A narrow trunk with residual blocks and drop-connect at rate 0.5
    (blocks 1b and 2b drop at 0.125 and 0.375), BN statistics in [0.01,
    0.05]."""
    trunk = EfficientNet(width_coefficient=0.25, drop_connect_rate=0.5,
                         blocks=(BlockArgs(3, 2, 32, 16, 1, 1), BlockArgs(3, 2, 16, 24, 6, 2)))
    model = lecun_init_(KWSEmbeddingModel(4, trunk), 0)
    gen = torch.Generator().manual_seed(1)
    for name, t in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            t.copy_(torch.rand(t.shape, generator=gen) * 0.04 + 0.01)
    return model


def _batch():
    rng = np.random.default_rng(0)
    specs = rng.normal(120, 80, (GLOBAL_BATCH, 49, 40, 1)).astype(np.float32)
    return torch.from_numpy(specs), torch.arange(GLOBAL_BATCH) % 4


def _train_step(model, specs, labels, group):
    step, _ = make_pretrain_step(model, torch.optim.SGD(model.parameters(), lr=0.1), group)
    return step(specs, labels, torch.Generator().manual_seed(5))


def _worker(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    mesh.initialize_distributed("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                                timeout=timedelta(seconds=60))
    try:
        model = _model()
        specs, labels = _batch()
        rows = mesh.local_rows(GLOBAL_BATCH)
        metrics = _train_step(model, specs[rows], labels[rows], mesh.default_group())
        # BN and drop-connect span the default group: a step over another
        # group, or over none, would mix two groups and is refused
        other = dist.new_group([0, 1])
        refused = []
        for group in (other, None):
            try:
                make_pretrain_step(model, torch.optim.SGD(model.parameters(), lr=0.1), group)
            except ValueError:
                refused.append(group is None)
        model.eval()
        rng = np.random.default_rng(1)
        predict = mesh.make_sharded_predict(lambda x: model(x))
        inputs = {n: torch.from_numpy(rng.normal(120, 80, (n, 49, 40, 1)).astype(np.float32)) for n in PREDICT_ROWS}
        with torch.no_grad():
            sharded = {n: predict(x) for n, x in inputs.items()}
            plain = {n: model(x) for n, x in inputs.items()}
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()}, "state": model.state_dict(),
                    "sharded": sharded, "plain": plain, "world": mesh.world_size(), "rank": mesh.rank(),
                    "refused": refused},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, 2, str(tmp / "store"), str(tmp))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(timeout=10)
    assert not hung, "a gloo worker did not finish within 180 s"
    assert [p.exitcode for p in procs] == [0, 0]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(2)]


def test_two_processes_match_one(two_ranks):
    model = _model()
    specs, labels = _batch()
    want = _train_step(model, specs, labels, None)
    ref = model.state_dict()
    assert [(r["rank"], r["world"]) for r in two_ranks] == [(0, 2), (1, 2)]
    for res in two_ranks:
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(res["metrics"][k], float(want[k]), rtol=1e-5, err_msg=k)
        assert set(res["state"]) == set(ref)
        for k, t in res["state"].items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=1e-5, err_msg=k)
            elif not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=1e-3, atol=1e-4, err_msg=k)
    # the step did train, and drop-connect mattered: without the masks the
    # same step lands elsewhere
    moved = _model().state_dict()
    assert any(not torch.equal(moved[k], t) for k, t in ref.items() if k.endswith("weight"))
    no_drop = _model()
    for name in no_drop.trunk.block_names:
        getattr(no_drop.trunk, name).drop_rate = 0.0
    loss_no_drop = float(_train_step(no_drop, specs, labels, None)["loss"])
    assert abs(loss_no_drop - float(want["loss"])) > 1e-4


def test_pretrain_step_runs_over_the_default_group_only(two_ranks):
    assert [r["refused"] for r in two_ranks] == [[False, True]] * 2
    model = _model()
    with pytest.raises(ValueError):  # a group where none is up
        make_pretrain_step(model, torch.optim.SGD(model.parameters(), lr=0.1), object())


def test_sharded_predict_matches_plain(two_ranks):
    for res in two_ranks:
        for n in PREDICT_ROWS:
            got, want = res["sharded"][n], res["plain"][n]
            assert got.shape == want.shape == (n, 4)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=str(n))
    # in a single process it is the predictor itself
    x = torch.randn(5, 3)
    assert torch.equal(mesh.make_sharded_predict(lambda b: b * 2)(x), x * 2)


def test_pad_to_multiple():
    batch = np.arange(10, dtype=np.float32)[:, None]
    padded, real = mesh.pad_to_multiple(batch, 8)
    assert padded.shape == (16, 1) and real == 10
    np.testing.assert_array_equal(padded[10:], 9.0)
    same, real = mesh.pad_to_multiple(batch, 5)
    assert same is batch and real == 10
    t, real = mesh.pad_to_multiple(torch.arange(6).reshape(3, 2), 4, axis=1)
    assert real == 2 and torch.equal(t, torch.tensor([[0, 1, 1, 1], [2, 3, 3, 3], [4, 5, 5, 5]]))
    assert mesh.local_rows(8, (1, 2)) == slice(4, 8)
    with pytest.raises(ValueError):
        mesh.local_rows(10, (0, 4))


def test_initialize_distributed_is_a_no_op_in_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.initialize_distributed() is False
    assert not dist.is_initialized()
    assert (mesh.world_size(), mesh.rank(), mesh.default_group()) == (1, 0, None)
    assert mesh.local_rows(8) == slice(0, 8)


@pytest.mark.parametrize("resident", [False, True], ids=["streaming", "resident"])
def test_sharded_batches_are_rows_of_the_global_batch(tmp_path, resident):
    """A rank's training batches (``AudioDataset(shard=...)``) are its rows
    of the batches one process makes from the same seed: the same clips,
    augmentation, SpecAugment masks and labels (the plain versions of the
    kernels run here, so ==)."""
    corpus = make_corpus(tmp_path, clips_per_word=4)
    files = corpus["alpha"] + corpus["bravo"]
    labels = [f.split("/")[-2] for f in files]

    def batches(shard):
        ds = AudioDataset(standard_microspeech_model_settings(4), ["alpha", "bravo"], corpus["bg_dir"],
                          corpus["unknown_files"], silence_percentage=25.0, unknown_percentage=25.0, seed=3,
                          device="cpu", shard=shard)
        if resident:
            return list(ds.train_batches_resident(files, 8, 3, labels=labels, single_target=False))
        return list(ds.train_batches(files, 8, 3, labels=labels, single_target=False, prefetch=2))

    whole = batches((0, 1))
    parts = [batches((r, 2)) for r in range(2)]
    for i, (specs, lbl) in enumerate(whole):
        assert torch.equal(torch.cat([p[i][0] for p in parts]), specs), i
        assert torch.equal(torch.cat([p[i][1] for p in parts]), lbl), i
