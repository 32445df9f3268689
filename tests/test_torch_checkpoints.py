"""The port's checkpoints (train/checkpoints.py) and what loads them:
``transfer_learn(base_model_path=...)`` and ``eval_stream_test(model_path=...)``,
against the JAX package on a narrow trunk (width 0.25, depth 0.1, as
tests/test_cli.py uses).

The JAX package writes orbax checkpoints; ``convert_jax_checkpoint`` carries
one across (its trees through ``models/convert.flax_to_state_dict``, then the
port's ``save_model`` with the same metadata).

Tolerances, and why:

- crash windows, round trips, frozen tensors and the state a fine-tune
  starts from: bitwise (``torch.save`` stores the tensors as they are);
- softmax rows of the streaming engine: atol 1e-5, as
  tests/test_torch_stream.py (the features are bit-identical, the model
  differs by float32 sum order); detections equal.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import keyword_clip, make_corpus
from multilingual_kws_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from multilingual_kws_tpu.models.kws_model import KWSEmbeddingModel as JaxEmbeddingModel
from multilingual_kws_tpu.models.kws_model import KWSTransferModel as JaxTransferModel
from multilingual_kws_tpu.stream import engine as jax_engine
from multilingual_kws_tpu.tools.stream_synth import synthesize_stream, write_stream
from multilingual_kws_tpu.train import checkpoints as jax_ckpt
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel, lecun_init_
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.stream import engine as port_engine
from multilingual_kws_tpu_torch.train import checkpoints as ck
from multilingual_kws_tpu_torch.train import finetune
from multilingual_kws_tpu_torch.utils.wav import read_wav


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDTH, DEPTH = 0.25, 0.1
THRESHOLDS = [0.3, 0.5, 0.7, 0.9]


def convert_jax_checkpoint(src, dst) -> None:
    """A checkpoint the JAX package's ``save_model`` wrote (orbax) -> the
    port's, with the same metadata (the port sets its own ``format``)."""
    payload, meta = jax_ckpt.load_model(src)
    ck.save_model(dst, flax_to_state_dict(jax.tree_util.tree_map(np.asarray, payload)), metadata=meta)


def _jax_variables(model, seed: int):
    """Seeded Flax variables of ``model``'s structure (traced, not
    compiled): kernels of variance 1/fan_in, BN scales, biases and
    statistics away from their init (so that a lost BN statistic shows)."""
    x = jnp.zeros((1, 49, 40, 1), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.8, 1.5, shape)
        else:  # bias, mean
            a = rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, {k: shapes[k] for k in ("params", "batch_stats")})


def _narrow():
    return JaxEfficientNet(width_coefficient=WIDTH, depth_coefficient=DEPTH)


def _stream_flags(module, wav, labels):
    return module.StreamFlags(wav=wav, ground_truth=labels, target_keyword="alpha", detection_thresholds=THRESHOLDS)


def build_checkpoints(root):
    """JAX checkpoints of a narrow embedding model and a narrow transfer
    model (its target bias raised so that the target wins about half of a
    synthesized stream's windows, as tests/test_torch_stream.py does), each
    converted to the port's; the stream and its labels; a few-shot corpus.
    Returns a dict of paths, and the embedding's Flax variables."""
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    emb = _jax_variables(JaxEmbeddingModel(num_labels=5, trunk=_narrow()), seed=3)
    meta = {"kind": "embedding", "width_coefficient": WIDTH, "depth_coefficient": DEPTH}
    jax_ckpt.save_model(root / "jax_embedding", emb["params"], emb["batch_stats"], meta)

    spec = synthesize_stream(
        "alpha",
        [keyword_clip("alpha", seed=1100 + i) for i in range(3)],
        [keyword_clip("charlie", seed=2100 + i) for i in range(3)],
        num_targets=3, num_distractors=3, seed=6, noise_rms=0.003,
    )
    out["wav"], out["labels"] = str(root / "stream.wav"), str(root / "labels.txt")
    write_stream(spec, out["wav"], out["labels"])

    xfer = _jax_variables(JaxTransferModel(trunk=_narrow(), num_categories=3), seed=4)
    tm = KWSTransferModel(EfficientNet(width_coefficient=WIDTH, depth_coefficient=DEPTH), 3).eval()
    tm.load_state_dict(flax_to_state_dict(xfer), strict=True)
    audio, sr = read_wav(out["wav"])
    feats = port_engine.featurize_stream(
        audio, sr, _stream_flags(port_engine, out["wav"], out["labels"]), MicroFrontendTorch(device="cpu")
    )
    with torch.no_grad():
        p = tm(torch.from_numpy(feats)[..., None]).numpy()
    xfer["params"]["transfer_head"]["out"]["bias"][2] += np.median(np.log(p[:, :2].max(1) / p[:, 2]))
    meta = {"kind": "transfer", "target": "alpha", "details": {"val_accuracy": 1.0},
            "width_coefficient": WIDTH, "depth_coefficient": DEPTH}
    jax_ckpt.save_model(root / "jax_transfer", xfer["params"], xfer["batch_stats"], meta)

    for name in ("embedding", "transfer"):
        out[f"jax_{name}"] = str(root / f"jax_{name}")
        out[name] = str(root / name)
        convert_jax_checkpoint(out[f"jax_{name}"], out[name])
    out["corpus"] = make_corpus(root / "corpus", clips_per_word=8)
    return out, emb


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    return build_checkpoints(tmp_path_factory.mktemp("torch_ckpt"))


# ---------------------------------------------------------------------------
# crash safety: tests/test_checkpoint_crash_safety.py's windows, on the port
# ---------------------------------------------------------------------------


def _save(path, tag: float, epoch: int) -> None:
    ck.save_model(path, {"dense.weight": torch.full((2, 2), tag)}, metadata={"epoch": epoch})


def _load(path):
    state, meta = ck.load_model(path, device="cpu")
    return float(state["dense.weight"][0, 0]), meta["epoch"]


def _no_siblings(path) -> None:
    assert not (path.parent / "ckpt.saving").exists()
    assert not (path.parent / "ckpt.prev").exists()


def _roundtrip(path):
    _save(path, 1.0, 3)
    assert _load(path) == (1.0, 3)
    _no_siblings(path)


def _overwrite(path):
    _save(path, 1.0, 1)
    _save(path, 2.0, 2)
    assert _load(path) == (2.0, 2)
    _no_siblings(path)


def _killed_mid_build(path):
    """A partial state in .saving and no metadata: the old checkpoint wins,
    and the next save clears the partial directory."""
    _save(path, 1.0, 1)
    saving = path.parent / "ckpt.saving"
    saving.mkdir()
    (saving / ck.STATE_FILE).write_bytes(b"partial torch.save write")
    assert _load(path) == (1.0, 1)
    _save(path, 3.0, 3)
    assert not saving.exists() and _load(path) == (3.0, 3)


def _killed_before_swap(path):
    """A complete .saving and no rename yet: .saving is the newest."""
    _save(path, 1.0, 1)
    _save(path, 2.0, 2)
    _save(path.parent / "other", 3.0, 3)
    (path.parent / "other").rename(path.parent / "ckpt.saving")
    assert _load(path) == (3.0, 3)


def _killed_between_renames(path):
    """path -> .prev done, .saving -> path not: .saving wins, .prev next."""
    _save(path, 2.0, 2)
    path.rename(path.parent / "ckpt.prev")
    _save(path.parent / "other", 3.0, 3)
    (path.parent / "other").rename(path.parent / "ckpt.saving")
    assert _load(path) == (3.0, 3)
    shutil.rmtree(path.parent / "ckpt.saving")
    assert _load(path) == (2.0, 2)


def _metadata_recovers_alike(path):
    _save(path, 2.0, 2)
    path.rename(path.parent / "ckpt.prev")
    assert ck.load_metadata(path)["epoch"] == 2


def _missing_raises(path):
    with pytest.raises(FileNotFoundError):
        ck.load_model(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        ck.load_metadata(path)


CRASH_CASES = {
    "roundtrip": _roundtrip,
    "overwrite_leaves_no_siblings": _overwrite,
    "killed_mid_build": _killed_mid_build,
    "killed_after_build_before_swap": _killed_before_swap,
    "killed_between_renames": _killed_between_renames,
    "load_metadata_recovers_alike": _metadata_recovers_alike,
    "missing_checkpoint_raises": _missing_raises,
}


@pytest.mark.parametrize("case", list(CRASH_CASES))
def test_load_recovers_the_newest_complete_checkpoint(case, tmp_path):
    CRASH_CASES[case](tmp_path / "ckpt")


def test_metadata_and_state(tmp_path):
    """The metadata keys of the JAX package, the port's format, and a
    model's state_dict (BN statistics included) back bitwise."""
    model = lecun_init_(KWSTransferModel(EfficientNet(width_coefficient=WIDTH, depth_coefficient=DEPTH), 3), 5)
    with torch.no_grad():
        model.trunk.stem.bn.running_var.add_(0.25)
    ck.save_model(tmp_path / "m", model, metadata={"kind": "transfer", "width_coefficient": WIDTH})
    meta = ck.load_metadata(tmp_path / "m")
    assert meta == {"kind": "transfer", "width_coefficient": WIDTH, "format": ck.FORMAT,
                    "embedding_output": "embedding_head/dense_2", "has_batch_stats": True}
    state, _ = ck.load_model(tmp_path / "m", device="cpu")
    own = model.state_dict()
    assert list(state) == list(own)
    assert all(torch.equal(state[k], own[k]) for k in own)
    ck.save_model(tmp_path / "p", {"w": torch.ones(2)})
    assert ck.load_metadata(tmp_path / "p")["has_batch_stats"] is False


def test_sized_trunk_refuses_an_unknown_trunk():
    """A checkpoint's metadata comes from outside the program: a trunk kind
    the package does not know is refused, by name, not built as a B0."""
    with pytest.raises(ValueError, match="unknown trunk 'conformer'.*'wav2vec2' and EfficientNet"):
        ck.sized_trunk({"trunk": "conformer", "width_coefficient": 1.0})


def test_refuses_a_jax_checkpoint(made):
    paths, _ = made
    with pytest.raises(ValueError, match="flax_to_state_dict"):
        ck.load_model(paths["jax_embedding"], device="cpu")


def test_best_val_checkpoint_keeps_only_improvements(tmp_path):
    best = ck.BestValCheckpoint(tmp_path / "best")
    saved = [
        best.update({"val_accuracy": acc}, {"w": torch.full((1,), float(i))}, extra_meta={"epoch": i})
        for i, acc in enumerate([0.5, 0.4, 0.5, 0.7, 0.6])
    ]
    assert saved == [True, False, False, True, False]
    state, meta = ck.load_model(tmp_path / "best", device="cpu")
    assert float(state["w"]) == 3.0 and meta["epoch"] == 3 and meta["val_accuracy"] == 0.7


def test_converted_checkpoint_matches_flax_trees(made):
    """The converted embedding: every tensor == flax_to_state_dict of the
    Flax variables; the embedding views keep the trunk (with its BN
    statistics) and the embedding head, and drop the classifier."""
    paths, emb = made
    want = flax_to_state_dict(emb)
    state, meta = ck.load_model(paths["embedding"], device="cpu")
    assert list(state) == list(want) and all(torch.equal(state[k], want[k]) for k in want)
    assert meta["format"] == ck.FORMAT and meta["kind"] == "embedding"
    assert (meta["width_coefficient"], meta["depth_coefficient"]) == (WIDTH, DEPTH)
    variables = ck.load_embedding_variables(paths["embedding"], device="cpu")
    assert set(variables) == {k for k in want if k.split(".")[0] in ("trunk", "embedding_head")}
    assert "trunk.stem.bn.running_var" in variables
    params = ck.load_embedding_params(paths["embedding"], device="cpu")
    assert set(params) == {k for k in variables if not k.endswith(ck.BN_STATS)}


def _spy_on_training(monkeypatch):
    """Records the model's state when the first training phase is set up,
    and fails on BN calibration."""
    seen = []
    real = finetune.make_finetune_step

    def spy(model, *a, **kw):
        if not seen:
            seen.append({k: t.clone() for k, t in model.state_dict().items()})
        return real(model, *a, **kw)

    def no_calibration(*a, **kw):
        raise AssertionError("BN calibration ran on base weights")

    monkeypatch.setattr(finetune, "make_finetune_step", spy)
    monkeypatch.setattr(finetune, "calibrate_batch_stats", no_calibration)
    return seen


def test_transfer_learn_from_base_model_path(made, monkeypatch):
    """From the checkpoint, the fine-tune starts from the state that the
    same Flax trees passed as base_params give (trunk sized from the
    metadata, no BN calibration), and trains alike."""
    paths, emb = made
    corpus = paths["corpus"]
    common = dict(
        target="alpha", train_files=corpus["alpha"][:5], val_files=corpus["alpha"][5:],
        unknown_files=corpus["unknown_files"], num_epochs=1, batch_size=4, primary_lr=1e-2,
        bg_datadir=corpus["bg_dir"], seed=0, verbose=0, device="cpu",
    )
    starts, results = [], []
    for kw in (
        dict(base_model_path=paths["embedding"]),
        dict(base_params=emb["params"], base_batch_stats=emb["batch_stats"],
             model=lecun_init_(KWSTransferModel(EfficientNet(width_coefficient=WIDTH, depth_coefficient=DEPTH), 3), 0)),
    ):
        seen = _spy_on_training(monkeypatch)
        results.append(finetune.transfer_learn(**common, **kw))
        starts.append(seen[0])
    from_ckpt, from_trees = starts
    assert list(from_ckpt) == list(from_trees)
    for k, t in from_trees.items():
        assert torch.equal(from_ckpt[k], t), k
    base = flax_to_state_dict(emb)
    for k in ("trunk.stem.bn.running_mean", "trunk.top.bn.running_var", "embedding_head.dense_2.weight"):
        assert torch.equal(from_ckpt[k], base[k]), k
    for (k, t), u in zip(results[0].state_dict().items(), results[1].state_dict().values()):
        assert torch.equal(t, u), k


def _stream_rows(engine, st, **kw):
    res = engine.eval_stream_test(st, verbose=False, **kw)
    return res, np.load(st.destination_result_inferences)


def test_eval_stream_test_from_model_path(made, tmp_path):
    """The converted transfer checkpoint through the port's engine against
    the orbax original through the JAX engine: softmax rows within 1e-5,
    detections equal, and some threshold detects."""
    paths, _ = made
    rows, det = {}, {}
    for name, engine, model_path, kw in (
        ("jax", jax_engine, paths["jax_transfer"], {}),
        ("port", port_engine, paths["transfer"], {"device": "cpu"}),
    ):
        st = engine.StreamTarget(
            target_lang="syn", target_word="alpha", model_path=model_path,
            stream_flags=[_stream_flags(engine, paths["wav"], paths["labels"])],
            destination_result_inferences=str(tmp_path / f"{name}.npy"),
        )
        det[name], rows[name] = _stream_rows(engine, st, **kw)
    np.testing.assert_allclose(rows["port"], rows["jax"], rtol=0, atol=1e-5)
    got, want = det["port"]["alpha"][0][1], det["jax"]["alpha"][0][1]
    assert list(got) == list(want) == THRESHOLDS
    for th in THRESHOLDS:
        assert got[th][0] == want[th][0], th
        assert [c[:2] for c in got[th][1]] == [c[:2] for c in want[th][1]], th
        np.testing.assert_allclose([c[2] for c in got[th][1]], [c[2] for c in want[th][1]], atol=1e-5)
    assert any(got[th][0] for th in THRESHOLDS), "no threshold detected anything"
