"""The port's CLI (api/cli.py) on the CPU (``--device cpu``) against the JAX
package's, from a narrow embedding converted from a JAX checkpoint
(tests/test_torch_checkpoints.py builds it).

- ``train`` (1 epoch x 1 batch at batch 16) writes a transfer checkpoint
  with the metadata keys the JAX ``cmd_train`` writes; its trunk and
  embedding head are the embedding's, bitwise (the fine-tune freezes them);
- ``inference``, with and without ``--groundtruth``, on the same transfer
  weights as the JAX CLI's: the same detections.json, keywords and times
  equal and confidences within 1e-5 (the softmax tolerance of
  tests/test_torch_stream.py; a confidence is a mean of softmax scores);
- the visualizer's files are byte for byte the JAX package's;
- ``pretrain`` from manifests on a tiny corpus at width and depth 0.25
  (float32 and bfloat16) writes an embedding checkpoint that ``train
  --embedding`` fine-tunes from.
"""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multilingual_kws_tpu.api import cli as jax_cli
from multilingual_kws_tpu.api import visualizer as jax_visualizer
from multilingual_kws_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from multilingual_kws_tpu.train import finetune as jax_finetune
from multilingual_kws_tpu_torch.api import cli as port_cli
from multilingual_kws_tpu_torch.api import visualizer as port_visualizer
from multilingual_kws_tpu_torch.train import checkpoints as ck
from test_torch_checkpoints import DEPTH, WIDTH, build_checkpoints

THRESHOLD = "0.3"


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
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    paths, emb = build_checkpoints(root)
    samples = root / "samples"
    samples.mkdir()
    for i, f in enumerate(paths["corpus"]["alpha"][:5]):
        shutil.copy2(f, samples / f"alpha_{i}.wav")
    paths["samples"] = str(samples)
    return root, paths, emb


def _train_args(paths, output):
    corpus = paths["corpus"]
    return [
        "train", "--keyword", "alpha", "--samples-dir", paths["samples"], "--embedding", paths["embedding"],
        "--unknown-words", corpus["unknown_dir"], "--background-noise", corpus["bg_dir"], "--output", str(output),
        "--num-epochs", "1", "--num-batches", "1", "--batch-size", "16",
    ]


def test_train_writes_a_transfer_checkpoint(ws, monkeypatch):
    root, paths, emb = ws
    port_cli.main(_train_args(paths, root / "alpha_model") + ["--device", "cpu"])
    meta = ck.load_metadata(root / "alpha_model")
    state, _ = ck.load_model(root / "alpha_model", device="cpu")
    base, _ = ck.load_model(paths["embedding"], device="cpu")
    frozen = [k for k in state if k.split(".")[0] in ("trunk", "embedding_head")]
    assert frozen and all(torch.equal(state[k], base[k]) for k in frozen)
    assert {k.split(".")[0] for k in state} == {"trunk", "embedding_head", "transfer_head"}
    assert meta["kind"] == "transfer" and meta["target"] == "alpha"
    assert (meta["width_coefficient"], meta["depth_coefficient"]) == (WIDTH, DEPTH)
    assert set(meta["details"]) == {"num_epochs", "batch_size", "num_batches", "val_accuracy", "target"}

    # the metadata keys the JAX cmd_train writes: its own save, with its
    # fine-tune replaced by a stub holding the embedding's trees
    def stub(**kw):
        return SimpleNamespace(
            model=SimpleNamespace(trunk=JaxEfficientNet(width_coefficient=WIDTH, depth_coefficient=DEPTH)),
            state=SimpleNamespace(params=emb["params"], batch_stats=emb["batch_stats"]),
            details=meta["details"],
        )

    monkeypatch.setattr(jax_finetune, "transfer_learn", stub)
    jax_cli.main(_train_args(paths, root / "jax_alpha_model"))
    assert set(meta) == set(json.loads((root / "jax_alpha_model" / ck.METADATA_FILE).read_text()))


def _inference(main, modelpath, wav, out, groundtruth=None, extra=()):
    argv = ["inference", "--keywords", "alpha", "--modelpaths", modelpath, "--wav", wav,
            "--detection-threshold", THRESHOLD, "--write-detections", str(out), *extra]
    if groundtruth is not None:
        argv += ["--groundtruth", groundtruth]
    main(argv)
    return json.loads(Path(out).read_text())


@pytest.mark.parametrize("with_groundtruth", [True, False], ids=["groundtruth", "no_groundtruth"])
def test_inference_matches_jax_cli(ws, with_groundtruth):
    root, paths, _ = ws
    gt = paths["labels"] if with_groundtruth else None
    tag = "gt" if with_groundtruth else "nogt"
    got = _inference(port_cli.main, paths["transfer"], paths["wav"], root / f"port_{tag}.json", gt, ("--device", "cpu"))
    want = _inference(jax_cli.main, paths["jax_transfer"], paths["wav"], root / f"jax_{tag}.json", gt)
    assert got["keywords"] == want["keywords"] == ["alpha"]
    assert got["min_threshold"] == want["min_threshold"] == float(THRESHOLD)
    assert len(got["detections"]) == len(want["detections"]) > 0
    tags = {"tp", "fp", "fn"} if with_groundtruth else {"ng"}
    for g, w in zip(got["detections"], want["detections"]):
        assert set(g) == set(w) and g["groundtruth"] in tags
        assert {k: v for k, v in g.items() if k != "confidence"} == {k: v for k, v in w.items() if k != "confidence"}
        if "confidence" in w:
            np.testing.assert_allclose(g["confidence"], w["confidence"], atol=1e-5)


def test_visualizer_files_match_jax(ws):
    root, paths, _ = ws
    detections = {"keywords": ["alpha"], "min_threshold": 0.5,
                  "detections": [{"keyword": "alpha", "time_ms": 1234, "confidence": 0.75, "groundtruth": "tp"}]}
    dirs = {}
    for name, viz in (("port", port_visualizer), ("jax", jax_visualizer)):
        site = root / f"viz_{name}"
        viz.install_site(site)
        files = viz.assemble_visualizer_data(site / "data", paths["wav"], detections, transcript=paths["labels"])
        dirs[name] = (site, [Path(f).relative_to(site) for f in files])
    (port_site, port_files), (jax_site, jax_files) = dirs["port"], dirs["jax"]
    assert port_files == jax_files and len(port_files) == 4
    for rel in port_files + [Path("index.html")]:
        assert (port_site / rel).read_bytes() == (jax_site / rel).read_bytes(), rel
    with pytest.raises(FileExistsError):
        port_visualizer.assemble_visualizer_data(port_site / "data", paths["wav"], detections)


def test_bfloat16_is_refused(ws):
    """``--compute-dtype bfloat16`` was refused until the port computed in
    bf16; now ``train`` and ``inference`` run at it: the transfer checkpoint
    holds float32 tensors, its trunk and embedding head the embedding's, and
    detections.json is written. Compute dtypes the port has not got are
    still refused by the parser."""
    root, paths, _ = ws
    port_cli.main(_train_args(paths, root / "bf16") + ["--device", "cpu", "--compute-dtype", "bfloat16"])
    state, _ = ck.load_model(root / "bf16", device="cpu")
    base, _ = ck.load_model(paths["embedding"], device="cpu")
    assert all(t.dtype in (torch.float32, torch.int64) for t in state.values())
    assert all(torch.equal(state[k], base[k]) for k in state if k.split(".")[0] in ("trunk", "embedding_head"))
    det = _inference(port_cli.main, str(root / "bf16"), paths["wav"], root / "bf16.json",
                     extra=("--device", "cpu", "--compute-dtype", "bfloat16"))
    assert det["keywords"] == ["alpha"] and det["min_threshold"] == float(THRESHOLD)
    with pytest.raises(SystemExit):
        port_cli.main(_train_args(paths, root / "f16") + ["--device", "cpu", "--compute-dtype", "float16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pretrain_then_train(ws, dtype):
    root, paths, _ = ws
    corpus = paths["corpus"]
    work = root / f"pretrain_{dtype}"
    work.mkdir()
    words = ["bravo", "charlie"]
    (work / "commands.txt").write_text("\n".join(words) + "\n")
    (work / "train_files.txt").write_text("\n".join(f for w in words for f in corpus[w][:6]) + "\n")
    (work / "val_files.txt").write_text("\n".join(f for w in words for f in corpus[w][6:]) + "\n")
    port_cli.main([
        "pretrain", "--commands", str(work / "commands.txt"), "--train-files", str(work / "train_files.txt"),
        "--val-files", str(work / "val_files.txt"), "--background-noise", corpus["bg_dir"],
        "--output", str(work / "emb"), "--num-epochs", "2", "--steps-per-epoch", "2", "--batch-size", "8",
        "--silence-percentage", "10", "--csvlog", str(work / "log.csv"), "--history", str(work / "history.json"),
        "--width-coefficient", "0.25", "--depth-coefficient", "0.25", "--compute-dtype", dtype,
        "--device", "cpu",
    ])
    meta = ck.load_metadata(work / "emb")
    assert meta["kind"] == "embedding" and meta["commands"] == ["_silence_", "bravo", "charlie"]
    assert (meta["width_coefficient"], meta["depth_coefficient"]) == (0.25, 0.25) and meta["num_labels"] == 3
    history = json.loads((work / "history.json").read_text())
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()
    emb, _ = ck.load_model(work / "emb", device="cpu")
    assert all(t.dtype in (torch.float32, torch.int64) for t in emb.values())
    port_cli.main(["train", "--keyword", "alpha", "--samples-dir", paths["samples"], "--embedding", str(work / "emb"),
                   "--unknown-words", corpus["unknown_dir"], "--background-noise", corpus["bg_dir"],
                   "--output", str(work / "alpha"), "--num-epochs", "1", "--num-batches", "1", "--batch-size", "8",
                   "--compute-dtype", dtype, "--device", "cpu"])
    state, tmeta = ck.load_model(work / "alpha", device="cpu")
    assert (tmeta["width_coefficient"], tmeta["depth_coefficient"]) == (0.25, 0.25)
    assert all(torch.equal(state[k], t) for k, t in emb.items() if k.split(".")[0] in ("trunk", "embedding_head"))


def test_pretrain_resumes_with_the_checkpoint_s_trunk(ws):
    """``pretrain --resume`` rebuilds the trunk from the resumed checkpoint,
    input prefix included (an imported Keras model carries one), and exits
    when the coefficient flags contradict it."""
    from multilingual_kws_tpu_torch.models.efficientnet import EfficientNet
    from multilingual_kws_tpu_torch.models.kws_model import KWSEmbeddingModel, lecun_init_

    root, paths, _ = ws
    corpus = paths["corpus"]
    work = root / "resume"
    work.mkdir()
    words = ["bravo", "charlie"]
    (work / "commands.txt").write_text("\n".join(words) + "\n")
    (work / "train_files.txt").write_text("\n".join(f for w in words for f in corpus[w][:6]) + "\n")
    (work / "val_files.txt").write_text("\n".join(f for w in words for f in corpus[w][6:]) + "\n")
    base = lecun_init_(KWSEmbeddingModel(3, EfficientNet(width_coefficient=0.25, depth_coefficient=0.25,
                                                         input_scale=0.5, input_bias=-3.0)), 0)
    ck.save_model(work / "base", base, {"kind": "embedding", "num_labels": 3, **ck.trunk_metadata(base.trunk)})
    args = [
        "pretrain", "--commands", str(work / "commands.txt"), "--train-files", str(work / "train_files.txt"),
        "--val-files", str(work / "val_files.txt"), "--background-noise", corpus["bg_dir"],
        "--output", str(work / "emb"), "--num-epochs", "1", "--steps-per-epoch", "1", "--batch-size", "8",
        "--silence-percentage", "10", "--resume", str(work / "base"), "--depth-coefficient", "0.25",
        "--device", "cpu",
    ]
    with pytest.raises(SystemExit, match=r"EfficientNet trunk with width and depth coefficients \(0.25, 0.25\), "
                                         r"but --width-coefficient and --depth-coefficient say \(0.5, 0.25\)"):
        port_cli.main(args + ["--width-coefficient", "0.5"])
    assert not (work / "emb").exists()
    port_cli.main(args + ["--width-coefficient", "0.25"])
    meta = ck.load_metadata(work / "emb")
    assert (meta["width_coefficient"], meta["depth_coefficient"]) == (0.25, 0.25)
    assert (meta["input_scale"], meta["input_bias"]) == (0.5, -3.0)
    state, _ = ck.load_model(work / "emb", device="cpu")
    assert any(not torch.equal(state[k], t) for k, t in base.state_dict().items())
