"""The port's analysis modules (multilingual_kws_tpu_torch/analysis/) against
the JAX package's, on the CPU, with a narrow transfer model (width 0.25,
depth 0.1) where a model is needed.

Tolerances, and why:

- the numpy modules (roc, streaming_roc, viz, model_analysis' ROC,
  dataperf, dataperf_io): == on the same inputs (copies of the same numpy
  code); the pb and npz files byte for byte (the clock pinned for the npz
  files, whose zip entries record their write time);
- k-means: torch cannot reproduce ``jax.random``, so the Lloyd updates start
  from the JAX package's kmeans++ centers (``kmeans_fit(..., n_iters=0)``)
  and end within 1e-5 of its 50 updates (float32 sums in another order);
- embeddings and softmax confidences against the Flax model on the same
  weights: 1e-5, tests/test_torch_model.py's.
"""

import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import keyword_clip, make_corpus
from multilingual_kws_tpu.analysis import dataperf as jax_dataperf
from multilingual_kws_tpu.analysis import dataperf_io as jax_dio
from multilingual_kws_tpu.analysis import distance_filtering as jax_df
from multilingual_kws_tpu.analysis import model_analysis as jax_ma
from multilingual_kws_tpu.analysis import per_speaker as jax_ps
from multilingual_kws_tpu.analysis import roc as jax_roc
from multilingual_kws_tpu.analysis import streaming_roc as jax_sroc
from multilingual_kws_tpu.analysis import sweeps as jax_sweeps
from multilingual_kws_tpu.analysis import viz as jax_viz
from multilingual_kws_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from multilingual_kws_tpu.models.kws_model import KWSTransferModel as JaxTransferModel
from multilingual_kws_tpu.stream import engine as jax_engine
from multilingual_kws_tpu.tools.stream_synth import synthesize_stream, write_stream
from multilingual_kws_tpu_torch.analysis import batch_jobs, dataperf, distance_filtering, model_analysis
from multilingual_kws_tpu_torch.analysis import dataperf_io as dio
from multilingual_kws_tpu_torch.analysis import per_speaker, roc, streaming_roc, sweeps, viz
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel, lecun_init_
from multilingual_kws_tpu_torch.stream import engine
from multilingual_kws_tpu_torch.train.finetune import FinetuneResult
from test_torch_checkpoints import DEPTH, WIDTH, _jax_variables

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(a, b, path="."):
    """Nested dicts, lists, tuples, sets and arrays: == leaf for leaf (NaN
    equal to NaN), and no tensor anywhere."""
    assert not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor), path
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _splits(rng, n):
    return dict(correct=list(rng.uniform(0.3, 1.0, n)), incorrect=list(rng.uniform(0.0, 0.7, n // 5)))


class _Flags:
    time_tolerance_ms = 750


def _stream_results(rng):
    found = {t: ([("alpha", int(ms)) for ms in np.sort(rng.integers(0, 60000, rng.integers(1, 12)))], [])
             for t in (0.2, 0.4, 0.5, 0.7, 0.9)}
    return {"alpha": [(_Flags(), found)]}


NUMPY_CASES = {
    "roc_sc": lambda m, rng: m["roc"].roc_sc(_splits(rng, 200), _splits(rng, 300)),
    "roc_single_target": lambda m, rng: m["roc"].roc_single_target(rng.uniform(0.3, 1, 300), rng.uniform(0, 0.7, 300)),
    "roc_single_target_f1": lambda m, rng: m["roc"].roc_single_target(
        rng.uniform(0.3, 1, 300), rng.uniform(0, 0.7, 300), f1_at_threshold=0.5),
    "eer": lambda m, rng: m["roc"].eer(rng.uniform(0.3, 1, 300), rng.uniform(0, 0.7, 300)),
    "calc_roc_auc": lambda m, rng: (lambda r: (r, m["ma"].auc(*r)))(m["ma"].calc_roc(_analysis_result(rng))),
    "roc_curve": lambda m, rng: m["ma"].roc_curve([_analysis_result(rng), _analysis_result(rng)]),
    "frr_far_curves": lambda m, rng: m["viz"].frr_far_curves(rng.uniform(0.5, 1, 100), rng.uniform(0, 0.5, 100)),
    "roc_band": lambda m, rng: m["viz"].roc_band([m["roc"].roc_sc(_splits(rng, 50), _splits(rng, 60))[:2]
                                                  for _ in range(4)]),
    "confusion": lambda m, rng: (lambda cm: (cm, m["viz"].top_confusions(cm, list("abcdef"), k=5)))(
        m["viz"].confusion_matrix(rng.integers(0, 6, 200), rng.integers(0, 6, 200), 6)),
    "detection_video_frames": lambda m, rng: m["viz"].detection_video_frames(
        rng.uniform(0, 1, (250, 3)), np.arange(250) * 20, [["kw", 1500], ["kw", 4100]], "kw", window_s=1.0, fps=4.0),
    "streaming_roc": lambda m, rng: (lambda r: (r, m["sroc"].operating_point(r), m["sroc"].frr_fa_view(r)))(
        m["sroc"].streaming_roc(_stream_results(rng), "alpha", list(rng.integers(0, 60000, 8)), 60.0,
                                num_nontarget_words=40)),
    "dataperf_words": lambda m, rng: (
        m["dio"].keyword_counts([(w, s) for w, s in zip(rng.choice(list("abcdefg"), 300),
                                                        rng.choice(["validation", "train", None], 300))]),
        m["dio"].select_experiment_keywords({w: int(c) for w, c in zip("abcdefg", rng.integers(50, 200, 7))}, n=3),
        m["dataperf"].candidate_words({w: int(c) for w, c in zip("abcdefg", rng.integers(300, 700, 7))}, 500)),
    "evaluate_selection": lambda m, rng: (lambda v, lab: m["dataperf"].run_harness(
        lambda pool, n: np.arange(n), v[:60], lab[:60], v[60:], lab[60:], num_to_select=30,
        params=m["dataperf"].TestParams(num_splits_per_experiment=3)))(*_labelled(rng)),
}


def _labelled(rng):
    """100 vectors of two classes, shuffled: (vectors, 0/1 labels)."""
    order = rng.permutation(100)
    return (rng.normal(0, 1, (100, 8)) + np.repeat([[0.0], [1.0]], 50, axis=0))[order], np.repeat([0, 1], 50)[order]


def _analysis_result(rng):
    return {"target_keywords": _splits(rng, 40), "oov": _splits(rng, 30), "unknown_training": _splits(rng, 30),
            "original_embedding": _splits(rng, 20), "words": ["w"], "val_acc": 0.9}


@pytest.mark.parametrize("case", list(NUMPY_CASES))
def test_numpy_modules_equal_the_jax_modules(case):
    port = {"roc": roc, "ma": model_analysis, "viz": viz, "sroc": streaming_roc, "dio": dio, "dataperf": dataperf}
    ref = {"roc": jax_roc, "ma": jax_ma, "viz": jax_viz, "sroc": jax_sroc, "dio": jax_dio, "dataperf": jax_dataperf}
    if case == "evaluate_selection":
        pytest.importorskip("sklearn")
    assert_same(NUMPY_CASES[case](port, np.random.default_rng(1)), NUMPY_CASES[case](ref, np.random.default_rng(1)))


# -- dataperf_io -----------------------------------------------------------


def _samples(n=6, dim=192, seed=0):
    rng = np.random.default_rng(seed)
    return [dio.Sample("target" if i % 2 == 0 else "nontarget", f"en/clips/common_voice_{i}.wav",
                       rng.normal(0, 1, dim).astype(np.float32)) for i in range(n)]


def test_dataperf_files_equal_the_jax_modules(tmp_path, monkeypatch):
    samples = _samples()
    jax_samples = [jax_dio.Sample(s.sample_type, s.sample_id, s.vector) for s in samples]
    dio.save_pb(tmp_path / "port.pb", samples)
    jax_dio.save_pb(tmp_path / "jax.pb", jax_samples)
    assert (tmp_path / "port.pb").read_bytes() == (tmp_path / "jax.pb").read_bytes()
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)  # a zip entry records its write time
    dio.save_npz(tmp_path / "port.npz", samples)
    jax_dio.save_npz(tmp_path / "jax.npz", jax_samples)
    assert (tmp_path / "port.npz").read_bytes() == (tmp_path / "jax.npz").read_bytes()
    for loaded in (dio.load_pb(tmp_path / "jax.pb"), dio.load_npz(tmp_path / "jax.npz"),
                   jax_dio.load_pb(tmp_path / "port.pb")):
        assert [(s.sample_type, s.sample_id) for s in loaded] == [(s.sample_type, s.sample_id) for s in samples]
        for s, want in zip(loaded, samples):
            np.testing.assert_array_equal(s.vector, want.vector)

    ids = [s.sample_id for s in samples]
    eval_yaml = {"targets": {"w": ids, "other": ["x"]}}
    ratings = {c: ("bad" if i in (1, 4) else "good") for i, c in enumerate(ids)}
    embeddings = {s.sample_id: s.vector for s in samples}
    assert_same(dio.target_validation_filter("w", eval_yaml, ratings, embeddings),
                jax_dio.target_validation_filter("w", eval_yaml, ratings, embeddings))


# -- k-means and distance filtering ------------------------------------------


def test_lloyd_from_the_jax_seeding_matches_jax():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(c, 0.3, (40, 16)) for c in (0.0, 1.0, -1.0, 0.5)]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    seeded = np.asarray(jax_df.kmeans_fit(key, jnp.asarray(pts), 4, n_iters=0))
    want = np.asarray(jax_df.kmeans_fit(key, jnp.asarray(pts), 4, n_iters=50))
    got = distance_filtering.kmeans_lloyd(torch.from_numpy(pts), torch.tensor(seeded), n_iters=50).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # an empty cluster keeps its center
    far = np.vstack([seeded[:3], np.full((1, 16), 100.0, np.float32)])
    got = distance_filtering.kmeans_lloyd(torch.from_numpy(pts), torch.from_numpy(far), n_iters=5).numpy()
    np.testing.assert_array_equal(got[3], far[3])


def test_kmeans_seeding_draws_points_from_its_generator():
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.normal(0, 1, (50, 8)).astype(np.float32))

    def seed(s, points=pts):
        return distance_filtering.kmeans_seed(points, 5, torch.Generator().manual_seed(s))

    a = seed(7)
    assert torch.equal(a, seed(7)) and not torch.equal(a, seed(8))
    rows = [int((pts == c).all(1).nonzero()) for c in a]
    assert len(set(rows)) == 5  # distinct points: a seeded point has probability 0
    same = torch.ones(10, 8)  # every point on the first center: uniform draws
    assert torch.equal(seed(7, same), torch.ones(5, 8))


@pytest.fixture(scope="module")
def narrow():
    """(Flax module, Flax variables, port model) of a narrow transfer model
    with the same weights."""
    module = JaxTransferModel(trunk=JaxEfficientNet(WIDTH, DEPTH), num_categories=3)
    variables = _jax_variables(module, seed=21)
    model = KWSTransferModel(EfficientNet(width_coefficient=WIDTH, depth_coefficient=DEPTH), 3).eval()
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module, variables, model


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return {**make_corpus(root, clips_per_word=8), "root": str(root)}


def test_embedding_fn_matches_jax(narrow):
    module, variables, model = narrow
    x = np.random.default_rng(2).normal(4, 3, (4, 49, 40, 1)).astype(np.float32)
    want = jax_df.make_embedding_fn(module, variables)(x)
    np.testing.assert_allclose(distance_filtering.make_embedding_fn(model)(x), want, atol=TOL, rtol=TOL)


def test_cluster_and_sort(narrow, corpus):
    _, _, model = narrow
    files = corpus["alpha"] + corpus["charlie"][:3]
    emb = distance_filtering.make_embedding_fn(model)
    res = distance_filtering.cluster_and_sort(files, emb, seed=3, n_train=6, n_clusters=2, device="cpu")
    perm = np.random.RandomState(3).permutation(np.asarray(files, dtype=object))  # the JAX package's split
    assert list(res["train_clips"]) == list(perm[:6])
    assert sorted(res["sorted_clips"]) == sorted(perm[6:])
    assert res["cluster_centers"].shape == (2, 192) and np.all(np.diff(res["distances"]) >= 0)
    vecs = emb(distance_filtering.featurize_files(list(res["sorted_clips"]), device="cpu")[..., None])
    d = np.linalg.norm(res["cluster_centers"][None] - vecs[:, None], axis=-1).min(1)
    np.testing.assert_allclose(res["distances"], d, atol=TOL, rtol=TOL)
    again = distance_filtering.cluster_and_sort(files, emb, seed=3, n_train=6, n_clusters=2, device="cpu")
    np.testing.assert_array_equal(again["cluster_centers"], res["cluster_centers"])


def test_analyze_model_matches_jax(narrow, corpus):
    module, variables, model = narrow
    apply = jax.jit(lambda x: module.apply(variables, x, train=False))
    kw = dict(model_commands=["alpha"], val_acc=0.5, data_dir=corpus["root"], unknown_training_words=["bravo"],
              oov_words=["charlie", "bravo"], embedding_commands=["bravo", "charlie"], num_samples_command=6,
              n_words_oov_unknown=1, n_examples_oov_unknown=5, seed=4)
    want = jax_ma.analyze_model(lambda s: np.asarray(apply(s)), **kw)
    got = model_analysis.analyze_model(FinetuneResult("n", model, {}, None).predict_fn(), device="cpu", **kw)
    for key in ("oov_testing", "unknown_training_words", "original_embedding_words", "words", "val_acc"):
        assert_same(got[key] if key != "oov_testing" else sorted(got[key]),
                    want[key] if key != "oov_testing" else sorted(want[key]))
    for key in ("target_keywords", "oov", "unknown_training", "original_embedding"):
        for split in ("correct", "incorrect"):
            np.testing.assert_allclose(got[key][split], want[key][split], atol=TOL, rtol=TOL)


# -- orchestration: sweeps, batch jobs, per-speaker ----------------------------


def _fresh_model():
    return lecun_init_(KWSTransferModel(EfficientNet(width_coefficient=WIDTH, depth_coefficient=DEPTH), 3), 0)


def test_sweep_point_resume_and_pickles(corpus, tmp_path):
    data_dir = corpus["root"]
    sp = sweeps.SweepPoint(
        ix=0, trial=0, target="alpha", train_files=corpus["alpha"][:5], val_files=corpus["alpha"][5:],
        unknown_files=corpus["unknown_files"], unknown_sample=["bravo"], num_epochs=1, num_batches=1,
        batch_size=4, primary_lr=1e-2,
    )
    model = _fresh_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = sweeps.run_sweep_point(sp, tmp_path / "sweep", data_dir, bg_datadir=corpus["bg_dir"], model=model,
                                 n_target_eval=6, n_unknown_eval=6, device="cpu")
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())  # copied, not trained
    with open(tmp_path / "sweep/results/hpsweep_000.pkl", "rb") as fh:
        assert_same(pickle.load(fh), out)  # numpy and plain Python only
    assert len(out["target_results"]["correct"]) + len(out["target_results"]["incorrect"]) == 6
    assert sweeps.run_sweep_point(sp, tmp_path / "sweep", data_dir, device="cpu") is None
    saved = list((tmp_path / "sweep/models").iterdir())
    assert len(saved) == 1 and saved[0].name.startswith("targetset0_trial0__xfer_epochs_1")
    ours, theirs = sweeps.load_sweep_results(tmp_path / "sweep"), jax_sweeps.load_sweep_results(tmp_path / "sweep")
    assert len(ours) == 1
    assert_same(ours, theirs)


def _stream(tmp_path):
    spec = synthesize_stream(
        "alpha", [keyword_clip("alpha", seed=300 + i) for i in range(3)],
        [keyword_clip("charlie", seed=400 + i) for i in range(3)],
        num_targets=3, num_distractors=2, seed=5, noise_rms=0.003,
    )
    wav, labels = str(tmp_path / "stream.wav"), str(tmp_path / "labels.txt")
    write_stream(spec, wav, labels)
    return wav, labels, [ms for _, ms in spec.labels], len(spec.waveform) / spec.sample_rate


def test_run_job_skips_and_its_pickle_equals_a_direct_run(corpus, tmp_path):
    wav, labels, gt, duration = _stream(tmp_path)
    flags = engine.StreamFlags(wav=wav, ground_truth=labels, target_keyword="alpha",
                               detection_thresholds=[0.3, 0.4, 0.5, 0.6])
    st = engine.StreamTarget("x", "alpha", None, [flags], destination_result_pkl=str(tmp_path / "res/result.pkl"),
                             destination_result_inferences=str(tmp_path / "res/inferences.npy"))
    job = batch_jobs.TLData(
        train_files=corpus["alpha"][:5], val_files=corpus["alpha"][5:], n_batches=1, n_epochs=1,
        model_dest_dir=str(tmp_path / "models"), primary_lr=1e-2, backprop_into_embedding=False, embedding_lr=0.0,
        target="alpha", stream_targets=[st], batch_size=4,
    )
    name = batch_jobs.run_job(job, corpus["unknown_files"], None, corpus["bg_dir"], model=_fresh_model(),
                              device="cpu")
    with open(st.destination_result_pkl, "rb") as fh:
        results = pickle.load(fh)
    direct_inferences = str(tmp_path / "direct_inferences.npy")
    direct = engine.eval_stream_test(
        engine.StreamTarget("x", "alpha", str(tmp_path / "models" / name), [flags],
                            destination_result_inferences=direct_inferences), verbose=False, device="cpu")
    assert_same(results["alpha"][0][1], direct["alpha"][0][1])
    np.testing.assert_array_equal(np.load(st.destination_result_inferences), np.load(direct_inferences))
    assert batch_jobs.run_job(job, corpus["unknown_files"], None, corpus["bg_dir"], device="cpu") == "skipped"
    # the JAX package reads the port's stream pickle, and the port reads the JAX package's
    assert_same(streaming_roc.streaming_roc(results, "alpha", gt, duration, min_threshold=0.0),
                jax_sroc.streaming_roc(results, "alpha", gt, duration, min_threshold=0.0))
    jax_pkl = tmp_path / "jax/result.pkl"
    jax_flags = jax_engine.StreamFlags(wav=wav, ground_truth=labels, target_keyword="alpha",
                                       detection_thresholds=[0.3, 0.5, 0.7])

    def predict(specs):
        s = np.asarray(specs).mean(axis=(1, 2, 3))
        p2 = 1 / (1 + np.exp(-(s - np.median(s)) * 4))
        return np.stack([(1 - p2) / 2, (1 - p2) / 2, p2], axis=1).astype(np.float32)

    jax_engine.eval_stream_test(jax_engine.StreamTarget("x", "alpha", None, [jax_flags],
                                                        destination_result_pkl=str(jax_pkl)),
                                predict_fn=predict, verbose=False)
    rocs = [m.load_sweep_rocs(tmp_path / "jax", {"alpha": {"times": gt, "duration_s": duration}}, min_threshold=0.0)
            for m in (streaming_roc, jax_sroc)]
    assert len(rocs[0]) == 1 and rocs[0][0]["analyses"]
    assert_same(rocs[0], rocs[1])


def test_per_speaker(corpus):
    files = [f.replace("alpha_", f"spk{i // 8}_nohash_") for i, f in enumerate(corpus["alpha"])]
    assert_same(per_speaker.group_by_speaker(files), jax_ps.group_by_speaker(files))
    assert_same(per_speaker.group_by_speaker(["1089-134686-0000.wav", "1089-1-2.wav", "a_b.wav"]),
                jax_ps.group_by_speaker(["1089-134686-0000.wav", "1089-1-2.wav", "a_b.wav"]))
    by_speaker = {"s0": corpus["alpha"], "s1": corpus["charlie"][:3]}
    recs = per_speaker.per_speaker_eval("alpha", by_speaker, corpus["unknown_files"], corpus["bg_dir"], num_shots=5,
                                        num_epochs=1, batch_size=4, model=_fresh_model(), device="cpu")
    assert [r["speaker"] for r in recs] == ["s0"]
    r = recs[0]
    assert (r["num_shots"], r["num_held_out"], r["num_cross"]) == (5, 3, 3)
    assert 0.0 <= r["same_speaker_accuracy"] <= 1.0 and 0.0 <= r["cross_speaker_accuracy"] <= 1.0
