"""The port's per-step programs on the CPU: ``train/graphs.ProgramGraphs`` as
the JAX package's jitted per-step functions (``make_pretrain_step``'s and
``make_finetune_step``'s step and evaluate, the fused resident step, the
dataset's train and eval transforms, validation's scoring, ``kmeans_fit``).

On the CPU a program has no graph: each call is its function, and its keys
are kept as on a card. So:

(a) the entry points that go through the programs, ``pretrain()`` on the
streaming pipeline and with ``scan_epoch=False`` and
``transfer_learn(resident=False)``, are held ``==`` to the plain eager loops
they stand for, written here from the eager pieces (``_train_device``, the
steps' ``fn``, the frontend, the model): every epoch's metrics, every
tensor of the model, the optimizer's state and the generators' states;
(b) the keys: shapes, generators, the optimizer's state, the mode; epoch
bodies call no program;
(c) validation's sums against the JAX package's ``eval_fn`` on the same
specs and converted weights, an odd last batch and padded rows included:
the loss sum within rtol 1e-5 (one float32 eval forward on equal weights
and features, sums in another order: the single-step tests' bound,
tests/test_torch_pretrain.py), the correct count ``==``;
(d) ``kmeans_fit`` ``==`` ``kmeans_seed`` + ``kmeans_lloyd`` and the seeding
as it drew before, with a host sync, and, from the same centers, within
tests/test_torch_analysis.py's TOL of the JAX package's ``kmeans_fit`` (its
Lloyd loop sums N points in float32 in another order).

The graphs run only on a card: ``chip_smoke.py``'s phase n holds each
program graphed ``==`` eager there.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import make_corpus, tiny_embedding_model
from multilingual_kws_tpu.analysis import distance_filtering as jax_df
from multilingual_kws_tpu.parallel import mesh as jax_mesh
from multilingual_kws_tpu.train import pretrain as jax_pretrain
from multilingual_kws_tpu_torch.analysis import distance_filtering
from multilingual_kws_tpu_torch.data.dataset import AudioDataset
from multilingual_kws_tpu_torch.data.manifests import label_from_parent_dir
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.kws_model import KWSEmbeddingModel, KWSTransferModel, lecun_init_
from multilingual_kws_tpu_torch.ops.augment import SpecAugParams
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.train import graphs, steps
from multilingual_kws_tpu_torch.train import pretrain as pretrain_mod
from multilingual_kws_tpu_torch.train.finetune import _head_only, transfer_learn
from multilingual_kws_tpu_torch.train.pretrain import (PretrainConfig, _validate, build_fused_resident_epoch,
                                                       build_fused_resident_step, pretrain)
from test_torch_epoch import _assert_same_training, _residual_trunk, _tiny_trunk

BATCH = 8
STEPS = 3
EPOCHS = 2
WORDS = ["alpha", "bravo"]
LOSS_RTOL = 1e-5
KMEANS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (tests/test_torch_epoch.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), clips_per_word=8)


@pytest.fixture
def program_calls(monkeypatch):
    """Every ``ProgramGraphs`` call: (program, arguments)."""
    calls = []
    real = graphs.ProgramGraphs.__call__

    def spy(self, *args):
        calls.append((self, args))
        return real(self, *args)

    monkeypatch.setattr(graphs.ProgramGraphs, "__call__", spy)
    return calls


def _split(corpus):
    train = [f for w in WORDS for f in corpus[w][:6]]
    val = [f for w in WORDS for f in corpus[w][6:]] + corpus["alpha"][:3]  # 7 clips: an odd last batch
    return train, val


def _plain_validation(model, ds, files):
    """(loss sum, correct count) of eager forwards over eval batches."""
    labels = torch.tensor([ds.label_to_id[label_from_parent_dir(f)] for f in files])
    loss_sum, correct = 0.0, 0.0
    model.eval()
    for i in range(0, len(files), BATCH):
        wav = torch.from_numpy(ds._load_many(files[i:i + BATCH]))
        with torch.no_grad():
            logits = model(ds.frontend.features_from_int16(wav)[..., None])
        y = labels[i:i + BATCH]
        loss_sum += float(steps.sparse_ce_from_logits(logits, y).sum().double())
        correct += float((torch.argmax(logits, -1) == y).sum())
    return loss_sum, correct


def _plain_pretrain(corpus, model, config):
    """``pretrain()``'s loop from the eager pieces: each epoch's steps
    (``_train_device`` on an uploaded batch or on bank rows, then the step's
    ``fn``), one calibration batch, and the eager validation."""
    train, val = _split(corpus)
    labels = [label_from_parent_dir(f) for f in train]
    ds = AudioDataset(standard_microspeech_model_settings(len(WORDS) + 1), WORDS, corpus["bg_dir"], [],
                      silence_percentage=config.silence_percentage, unknown_percentage=0.0,
                      spec_aug_params=SpecAugParams(percentage=80), seed=config.shuffle_seed, device="cpu")
    opt = steps.flat_adam(model.parameters(), config.learning_rate)
    step = steps.make_pretrain_step(model, opt)[0].fn
    drop = torch.Generator().manual_seed(config.shuffle_seed + 1)
    resident = config.resident_data is not False
    bank = ds.build_resident_bank(train) if resident else None

    def batches(n):
        if resident:
            draws = list(ds.host_train_indices(train, BATCH, n, bank, labels=labels, single_target=False))
            idx, lbl, sil = ds._put_batch(tuple(np.stack(a) for a in zip(*draws)))
            return [(ds._train_device(bank["bank"], idx[i], sil[i]), lbl[i]) for i in range(n)]
        host = ds.host_train_batches(train, BATCH, n, labels=labels, single_target=False)
        rows = torch.arange(BATCH, dtype=torch.int32)
        return [(ds._train_device(wav, rows, sil), lbl) for wav, lbl, sil in map(ds._put_batch, host)]

    history = {"loss": [], "accuracy": [], "val_loss": [], "val_accuracy": []}
    for _ in range(config.num_epochs):
        ms = [step(specs, lbl, drop) for specs, lbl in batches(STEPS)]
        for k in ("loss", "accuracy"):
            history[k].append(float(np.mean(torch.stack([m[k] for m in ms]).numpy())))
        calib = [specs for specs, _ in batches(config.bn_calibration_batches)]
        steps.calibrate_batch_stats(model, calib, drop_generator=torch.Generator().manual_seed(0))
        loss_sum, correct = _plain_validation(model, ds, val)
        history["val_loss"].append(loss_sum / len(val))
        history["val_accuracy"].append(correct / len(val))
    return history, (model, opt, [ds.gen, drop])


@pytest.mark.parametrize("path", ["streaming", "resident step"])
def test_pretrain_through_the_programs_equals_the_eager_loop(corpus, program_calls, monkeypatch, path):
    """``pretrain(resident_data=False)`` (the transform and step programs,
    prefetch 2) and ``pretrain(scan_epoch=False)`` (the fused resident step
    program) against the plain loop: the history, every parameter and
    buffer, Adam's state, the dataset's and drop-connect's generators. The
    residual trunk draws drop-connect masks."""
    made = []
    real_adam = pretrain_mod.flat_adam
    monkeypatch.setattr(pretrain_mod, "flat_adam", lambda *a, **kw: made.append(real_adam(*a, **kw)) or made[-1])
    config = PretrainConfig(num_labels=len(WORDS) + 1, batch_size=BATCH, num_epochs=EPOCHS, steps_per_epoch=STEPS,
                            learning_rate=3e-3, silence_percentage=10.0, shuffle_seed=4, bn_calibration_batches=1,
                            resident_data=path != "streaming", scan_epoch=False, device="cpu")
    model = lecun_init_(KWSEmbeddingModel(len(WORDS) + 1, _residual_trunk()), 0)
    train, val = _split(corpus)
    twin = copy.deepcopy(model)
    got, hist, ds = pretrain(train, val, WORDS, corpus["bg_dir"], config=config, model=model, verbose=0)
    want_hist, want = _plain_pretrain(corpus, twin, config)
    assert hist == want_hist

    # the steps went through the step programs, the drop-connect generator
    # an argument of the streaming step and a generator of the fused one
    if path == "streaming":
        step_calls = [(p, a) for p, a in program_calls if p.optimizer is made[0]]
        drop = step_calls[0][1][2]
        assert all(a[2] is drop for _, a in step_calls)
        transforms = [p for p, _ in program_calls if p is ds._train_program]
        assert len(transforms) == EPOCHS * (STEPS + config.bn_calibration_batches)
    else:
        step_calls = [(p, a) for p, a in program_calls if p.optimizer is made[0]]
        (prog,) = {p for p, _ in step_calls}
        assert prog.generators[0] is ds.gen
        drop = prog.generators[1]
    assert len(step_calls) == EPOCHS * STEPS
    assert sum(p is ds._eval_program for p, _ in program_calls) == EPOCHS  # 7 clips: one batch of 8
    _assert_same_training((got, made[0], [ds.gen, drop]), want)


def test_streaming_transfer_learn_through_the_programs_equals_the_eager_loop(corpus, program_calls):
    """``transfer_learn(resident=False)``: BN calibration on the transform
    program's batches, each step the step program, each epoch's evaluation
    the eval transform and evaluate programs; against the plain loop."""
    kw = dict(num_epochs=EPOCHS, num_batches=1, batch_size=BATCH, primary_lr=1e-2, seed=3)
    train, val = corpus["alpha"][:5], corpus["alpha"][5:8] + corpus["unknown_files"][:2]
    model = lecun_init_(KWSTransferModel(_tiny_trunk(), 3), 0)
    twin = copy.deepcopy(model)
    result = transfer_learn("alpha", train, val, corpus["unknown_files"], bg_datadir=corpus["bg_dir"], verbose=0,
                            resident=False, model=model, device="cpu", **kw)
    assert {p.optimizer for p, _ in program_calls} >= {result.optimizer}
    assert sum(p.optimizer is result.optimizer for p, _ in program_calls) == EPOCHS * BATCH

    # the plain loop
    ds = AudioDataset(standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"], corpus["unknown_files"],
                      unknown_percentage=50.0, spec_aug_params=SpecAugParams(percentage=80), seed=kw["seed"],
                      device="cpu")
    rows = torch.arange(BATCH, dtype=torch.int32)

    def batches(n):
        host = ds.host_train_batches(train, BATCH, n)
        return [(ds._train_device(wav, rows, sil), lbl) for wav, lbl, sil in map(ds._put_batch, host)]

    steps.calibrate_batch_stats(twin, [s for s, _ in batches(2)], drop_generator=torch.Generator().manual_seed(0))
    step, evaluate, _ = steps.make_finetune_step(twin, kw["primary_lr"], _head_only)
    want = []
    for _ in range(EPOCHS):
        want.append([float(step.fn(specs, lbl)["loss"]) for specs, lbl in batches(BATCH)])
        wav = torch.from_numpy(ds._load_many(val))
        m = evaluate.fn(ds.frontend.features_from_int16(wav)[..., None], torch.full((len(val),), 2))
        # evaluate_dataset's weighted mean over its one batch
        assert result.history[0]["val_loss"][len(want) - 1] == float(m["loss"]) * len(val) / len(val)
    assert result.history[0]["step_loss"] == want
    _assert_same_training((result.model, result.optimizer, [result.dataset.gen]), (twin, step.optimizer, [ds.gen]))


def test_step_program_keys(corpus):
    """A step's key is taken after its eager call (Adam's state made), in
    the mode the program sets; a new batch shape, another generator and new
    optimizer state are new keys; only tensors, generators and None go in."""
    model = lecun_init_(KWSEmbeddingModel(3, _residual_trunk()), 0)
    opt = steps.flat_adam(model.parameters(), 1e-3)
    step, evaluate = steps.make_pretrain_step(model, opt)
    assert isinstance(step, graphs.ProgramGraphs) and step.optimizer is opt
    rng = np.random.default_rng(0)
    x8, x4 = (torch.from_numpy(rng.normal(0, 1, (n, 49, 40, 1)).astype(np.float32)) for n in (8, 4))
    y8, y4 = torch.zeros(8, dtype=torch.int64), torch.zeros(4, dtype=torch.int64)
    g, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    before = step.key(x8, y8, g)
    step(x8, y8, g)
    (k8,) = step.keys()
    assert k8 != before and k8[0] == before[0] and len(k8[1]) == len(before[1]) + 3 * len(opt.state)
    model.eval()
    evaluate(x8, y8)
    assert not model.training and len(evaluate.keys()) == 1
    step(x8, y8, g)  # the program puts the model in train mode: the same key
    assert step.keys() == [k8] and model.training
    step(x4, y4, g)
    assert step.keys()[0] == k8 and step.keys()[1][0][0][0] == (4, 49, 40, 1)
    assert step.key(x8, y8, g2) != k8 and step.key(x8, y8, g2)[1] == k8[1]
    # new optimizer state: a new key, and the old state's keys go
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    assert step.key(x8, y8, g) != k8
    step(x8, y8, g)
    assert len(step.keys()) == 1 and step.eager_calls == 4 and step.captures == 0
    # a new optimizer is a new program, whose first call is eager
    fresh, _ = steps.make_pretrain_step(model, steps.flat_adam(model.parameters(), 1e-3))
    assert fresh is not step and fresh.keys() == []
    with pytest.raises(TypeError, match="tensors, generators and None"):
        step(x8, y8, 3)
    # disable_graphs: the function, no key kept
    with graphs.disable_graphs():
        fresh(x8, y8, g)
    assert fresh.keys() == [] and fresh.eager_calls == 0

    # the dataset's transforms: one key a batch shape, the dataset's generator registered
    ds = AudioDataset(standard_microspeech_model_settings(3), WORDS, corpus["bg_dir"], [], seed=1, device="cpu")
    assert ds._train_program.generators == [ds.gen]
    for n in (2, 2, 3):
        next(ds.train_batches(corpus["alpha"][:4], n, 1))
    assert [k[0][1][0] for k in ds._train_program.keys()] == [(2,), (3,)]


def test_epoch_bodies_call_no_program(corpus, monkeypatch):
    """The resident epochs run the steps' eager functions: a program called
    inside an ``EpochGraph`` capture would replay a graph inside another
    graph's capture."""
    def boom(self, *args):
        raise AssertionError("a program called inside an epoch")

    files = corpus["alpha"][:4]
    ds = AudioDataset(standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"], corpus["unknown_files"],
                      seed=2, device="cpu")
    bank = ds.build_resident_bank(files)
    inputs = ds._put_batch(tuple(np.stack(a) for a in zip(*ds.host_train_indices(files, 4, 2, bank))))
    ft = steps.make_finetune_epoch_scan(lecun_init_(KWSTransferModel(_tiny_trunk(), 3), 0), 1e-3, _head_only, ds,
                                        bank["bank"], device="cpu")
    pt_model = lecun_init_(KWSEmbeddingModel(3, _residual_trunk()), 0)
    pt = build_fused_resident_epoch(pt_model, steps.flat_adam(pt_model.parameters(), 1e-3), None, ds, bank["bank"],
                                    torch.Generator().manual_seed(1), device="cpu")
    monkeypatch.setattr(graphs.ProgramGraphs, "__call__", boom)
    for epoch in (ft, pt):
        losses, _ = epoch(*inputs)
        assert losses.shape == (2,) and bool(torch.isfinite(losses).all())


def test_fused_resident_step_is_the_epoch_step(corpus):
    """``build_fused_resident_step`` takes the step of
    ``build_fused_resident_epoch``: the same metrics and state, bitwise."""
    files = corpus["alpha"][:4] + corpus["bravo"][:4]
    labels = ["alpha"] * 4 + ["bravo"] * 4
    sides = []
    for build in (build_fused_resident_epoch, build_fused_resident_step):
        ds = AudioDataset(standard_microspeech_model_settings(3), WORDS, corpus["bg_dir"], [],
                          silence_percentage=10.0, unknown_percentage=0.0, seed=6, device="cpu")
        bank = ds.build_resident_bank(files)
        model = lecun_init_(KWSEmbeddingModel(3, _residual_trunk()), 0)
        opt = steps.flat_adam(model.parameters(), 1e-3)
        drop = torch.Generator().manual_seed(2)
        run = build(model, opt, None, ds, bank["bank"], drop, device="cpu")
        idx, lbl, sil = ds._put_batch(tuple(np.stack(a) for a in zip(*ds.host_train_indices(
            files, 4, STEPS, bank, labels=labels, single_target=False))))
        if isinstance(run, graphs.EpochGraph):
            losses, accs = run(idx, lbl, sil)
        else:
            assert run.optimizer is opt and run.generators == [ds.gen, drop]
            losses, accs = (torch.stack(m) for m in zip(*[run(idx[i], lbl[i], sil[i]) for i in range(STEPS)]))
        sides.append(((losses, accs), (model, opt, [ds.gen, drop])))
    (ma, ta), (mb, tb) = sides
    assert torch.equal(ma[0], mb[0]) and torch.equal(ma[1], mb[1])
    _assert_same_training(ta, tb)


@pytest.fixture(scope="module")
def flax_embedding():
    """The tiny Flax embedding model of three labels, its weights moved off
    their init, and the port model with the same weights."""
    fm = tiny_embedding_model(num_labels=3)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 49, 40, 1))))
    rng = np.random.default_rng(2)
    v = {"params": jax.tree_util.tree_map(lambda a: (a * rng.uniform(0.8, 1.5, a.shape)).astype(np.float32),
                                          v["params"]),
         "batch_stats": jax.tree_util.tree_map(lambda a: (a + rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
                                               v["batch_stats"])}
    model = KWSEmbeddingModel(3, _tiny_trunk())
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    return fm, v, model.eval()


def test_validation_sums_match_the_jax_eval_fn(corpus, flax_embedding):
    """``_validate`` over 7 clips in batches of 4 (an odd last batch of 3),
    in one process and as the two ranks of a group of two (each batch padded
    to 4 rows, rank 1's last row padding, not counted; the ranks' sums
    added, as the all-reduce adds them), against the JAX package's
    ``eval_fn`` (loss mean times rows, correct count) on the same specs."""
    fm, v, model = flax_embedding
    _, val = _split(corpus)
    labels = [label_from_parent_dir(f) for f in val]
    init_fn, _, eval_fn = jax_pretrain.build_pretrain_step(fm, optax.adam(1e-3), jax_mesh.make_mesh(num_devices=1))
    state = init_fn(v)

    def dataset(shard):
        return AudioDataset(standard_microspeech_model_settings(3), WORDS, corpus["bg_dir"], [], seed=0,
                            device="cpu", shard=shard)

    ds = dataset((0, 1))
    want_loss, want_correct = 0.0, 0.0
    for i in range(0, len(val), 4):
        specs = ds._eval_device(torch.from_numpy(ds._load_many(val[i:i + 4])))
        y = np.array([ds.label_to_id[label] for label in labels[i:i + 4]], np.int32)
        loss, correct = eval_fn(state, jnp.asarray(specs.numpy()), jnp.asarray(y))
        want_loss += float(loss)
        want_correct += float(correct)
    whole = _validate(model, ds, val, labels, 4, None)
    ranks = [_validate(model, dataset((r, 2)), val, labels, 4, None) for r in range(2)]
    for loss_sum, correct, rows in (whole, (ranks[0][0] + ranks[1][0], ranks[0][1] + ranks[1][1], ranks[0][2])):
        assert rows == len(val) and correct == want_correct
        np.testing.assert_allclose(loss_sum, want_loss, rtol=LOSS_RTOL)
    # a padded row's score is not counted, whatever it holds
    specs = ds._eval_device(torch.from_numpy(ds._load_many(val[:4])))
    y = torch.tensor([ds.label_to_id[label] for label in labels[:4]])
    real = torch.tensor([True, True, True, False])
    sums = pretrain_mod._validation_sums(model, specs, y, real)
    other, y_other = specs.clone(), y.clone()
    other[3], y_other[3] = 1e3, (y[3] + 1) % 3
    assert torch.equal(sums, pretrain_mod._validation_sums(model, other, y_other, real))
    assert float(sums[1]) <= 3


def _multinomial_seed(points, n_clusters, generator):
    """``kmeans_seed`` as it drew before it was a device program: the
    uniform fallback chosen on the host."""
    first = torch.randint(points.shape[0], (1,), generator=generator)
    centers = points[first]
    for _ in range(1, n_clusters):
        d2 = ((points[:, None] - centers[None]) ** 2).sum(-1).min(dim=1).values
        weights = d2 if bool(d2.sum() > 0) else torch.ones_like(d2)
        centers = torch.cat([centers, points[torch.multinomial(weights, 1, generator=generator)]])
    return centers


@pytest.mark.parametrize("n,dim,k", [(50, 8, 5), (37, 192, 3), (10, 8, 5)])
def test_kmeans_fit_is_seed_and_lloyd(n, dim, k):
    rng = np.random.default_rng(n)
    pts = torch.from_numpy(rng.normal(0, 1, (n, dim)).astype(np.float32))
    if n == 10:
        pts = torch.ones(n, dim)  # every point on the first center: the uniform fallback
    gens = [torch.Generator().manual_seed(7) for _ in range(3)]
    got = distance_filtering.kmeans_fit(pts, k, gens[0], n_iters=20)
    seeded = distance_filtering.kmeans_seed(pts, k, gens[1])
    assert torch.equal(seeded, _multinomial_seed(pts, k, gens[2]))
    assert torch.equal(got, distance_filtering.kmeans_lloyd(pts, seeded, n_iters=20))
    assert torch.equal(gens[0].get_state(), gens[1].get_state()) and torch.equal(gens[1].get_state(),
                                                                                 gens[2].get_state())
    program = distance_filtering._fit_program(k, 20)
    assert program.keys()[-1][0] == (((n, dim), torch.float32, torch.device("cpu")), ("generator", id(gens[0])))


def test_kmeans_fit_from_the_same_centers_matches_jax(monkeypatch):
    """The program's Lloyd updates against the JAX package's ``kmeans_fit``
    whose seeding is made to pick the points the program's generator
    picked: its first draw and each scanned ``jax.random.choice``."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(c, 0.3, (40, 16)) for c in (0.0, 1.0, -1.0, 0.5)]).astype(np.float32)
    k = 4
    seeded = distance_filtering.kmeans_fit(torch.from_numpy(pts), k, torch.Generator().manual_seed(9), n_iters=0)
    picks = [int(np.flatnonzero((pts == c).all(1))[0]) for c in seeded.numpy()]
    got = distance_filtering.kmeans_fit(torch.from_numpy(pts), k, torch.Generator().manual_seed(9)).numpy()

    key = jax.random.PRNGKey(0)
    scan_keys = jax.random.split(jax.random.split(key)[1], k - 1)
    chosen = jnp.asarray(picks[1:])
    monkeypatch.setattr(jax.random, "randint", lambda *a, **kw: jnp.asarray(picks[0]))
    monkeypatch.setattr(jax.random, "choice", lambda key_i, n, p=None: chosen[
        jnp.argmax(jnp.all(scan_keys == key_i, axis=-1))])
    def seeding(key, points, n_clusters, n_iters):
        # a function of its own, so a trace of its own: JAX keeps the traces
        # of one function for every jit of it, and a trace of kmeans_fit
        # made earlier in this process would skip the patched draws
        return jax_df.kmeans_fit.__wrapped__(key, points, n_clusters, n_iters=n_iters)

    fit = jax.jit(seeding, static_argnames=("n_clusters", "n_iters"))
    np.testing.assert_array_equal(np.asarray(fit(key, jnp.asarray(pts), k, n_iters=0)), seeded.numpy())
    want = np.asarray(fit(key, jnp.asarray(pts), k, n_iters=50))
    np.testing.assert_allclose(got, want, atol=KMEANS_TOL, rtol=KMEANS_TOL)
