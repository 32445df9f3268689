"""Boundaries of the PyTorch port: what it imports, and how its entry points
behave without a card.

The port and ``chip_smoke.py`` import neither JAX (nor flax, optax, orbax)
nor any module of the JAX package; the entry points default to the card and
raise, rather than fall back to the CPU, when there is none.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multilingual_kws_tpu_torch import bench, graft_entry
from multilingual_kws_tpu_torch.analysis import batch_jobs, distance_filtering, model_analysis, per_speaker, sweeps
from multilingual_kws_tpu_torch.api import cli
from multilingual_kws_tpu_torch.data import dataset
from multilingual_kws_tpu_torch.examples import case_study, synth, tutorial
from multilingual_kws_tpu_torch.models import dscnn, export_tf, import_tf, kws_model, wav2vec2_embed
from multilingual_kws_tpu_torch.ops import micro_torch
from multilingual_kws_tpu_torch.probes import fft_cost, rates
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.stream import engine, realtime
from multilingual_kws_tpu_torch.train import checkpoints, evaluate, finetune, pretrain, steps
from multilingual_kws_tpu_torch.utils.wav import write_wav

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multilingual_kws_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "multilingual_kws_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "gate_drift.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "multilingual_kws_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_FLAGS = engine.StreamFlags(wav="", ground_truth="", target_keyword="x", detection_thresholds=[0.5])
_AUDIO = np.zeros(20000, np.float32)
_SETTINGS = standard_microspeech_model_settings(3)
_POINT = sweeps.SweepPoint(0, 0, "x", [], [], [], [], 1, 1, 1)
_JOB = batch_jobs.TLData([], [], 1, 1, "", 1e-3, False, 0.0, "x", [])
ENTRY_POINTS = {
    "MicroFrontendTorch": lambda: micro_torch.MicroFrontendTorch(),
    "MicroFrontendTorch_fast": lambda: micro_torch.MicroFrontendTorch(mode="fast"),
    "make_transfer_model": lambda: kws_model.make_transfer_model(),
    "make_embedding_model": lambda: kws_model.make_embedding_model(761),
    "pretrain": lambda: pretrain.pretrain(["x/a.wav"], [], ["x"], "no_such_dir"),
    "cli_pretrain": lambda: cli.main(["pretrain", "--commands", "c", "--train-files", "t", "--val-files", "v",
                                      "--background-noise", "b", "--output", "o"]),
    "stream_feature_chunks": lambda: next(engine.stream_feature_chunks(_AUDIO, 16000, _FLAGS)),
    "featurize_stream": lambda: engine.featurize_stream(_AUDIO, 16000, _FLAGS),
    "AudioDataset": lambda: dataset.AudioDataset(_SETTINGS, ["x"], "no_such_dir", []),
    "transfer_learn": lambda: finetune.transfer_learn("x", [], [], []),
    "make_finetune_epoch_scan": lambda: steps.make_finetune_epoch_scan(None, 1e-3, finetune._head_only, None, None),
    "build_fused_resident_epoch": lambda: pretrain.build_fused_resident_epoch(None, None, None, None, None, None),
    "featurize_files": lambda: evaluate.featurize_files(["no_such.wav"]),
    "file2spec": lambda: dataset.file2spec(_SETTINGS, "no_such.wav"),
    "measure_rates": lambda: rates.measure_rates(),
    "fft_cost": lambda: fft_cost.fft_cost(),
    "cli_inference": lambda: cli.main(["inference", "--keywords", "x", "--modelpaths", "no_such", "--wav", "no.wav"]),
    "cli_train": lambda: cli.main(["train", "--keyword", "x", "--samples-dir", "s", "--embedding", "e",
                                   "--unknown-words", "u", "--background-noise", "b", "--output", "o"]),
    "load_model": lambda: checkpoints.load_model("no_such_checkpoint"),
    "load_transfer_model": lambda: checkpoints.load_transfer_model("no_such_checkpoint"),
    "eval_stream_test_model_path": lambda: engine.eval_stream_test(
        engine.StreamTarget("x", "x", model_path="no_such_checkpoint", stream_flags=[_FLAGS])
    ),
    "RealtimeDetector": lambda: realtime.RealtimeDetector("x", lambda specs: specs),
    "import_tf_checkpoint": lambda: import_tf.import_tf_checkpoint("no_such_model"),
    "model_from_import": lambda: import_tf.model_from_import({}),
    "convert_checkpoint_and_save": lambda: export_tf.convert_checkpoint_and_save("no_such_checkpoint", "o.keras"),
    "cli_import_tf": lambda: cli.main(["import-tf", "no_such_model", "o"]),
    "cli_export_tf": lambda: cli.main(["export-tf", "no_such_checkpoint", "o.keras"]),
    "cluster_and_sort": lambda: distance_filtering.cluster_and_sort([f"{i}.wav" for i in range(60)], None),
    "analyze_model": lambda: model_analysis.analyze_model(None, ["x"], 0.0, "no_such_dir", [], [], []),
    "run_sweep_point": lambda: sweeps.run_sweep_point(_POINT, "no_such_dir", "no_such_dir"),
    "run_job": lambda: batch_jobs.run_job(_JOB, [], None, None),
    "BatchRunner": lambda: batch_jobs.BatchRunner("jobs.pkl", [], None, None),
    "per_speaker_eval": lambda: per_speaker.per_speaker_eval("x", {}, [], None),
    "DSCNN": lambda: dscnn.DSCNN(3),
    "Wav2Vec2Embedder": lambda: wav2vec2_embed.Wav2Vec2Embedder(model=object(), extractor=object()),
    "bench_main": lambda: bench.main([]),
    "bench_extra": lambda: bench.main(["--extra"]),
    "bench_preflight": lambda: bench.preflight_bit_exact_on_chip(8),
    "graft_entry": lambda: graft_entry.entry(),
    "dryrun_multichip": lambda: graft_entry.dryrun_multichip(1),
    "run_tutorial": lambda: tutorial.run_tutorial(Path("no_such_dir")),
    "case_study": lambda: case_study.main(["--workdir", "no_such_dir"]),
    "tiny_transfer_model": lambda: synth.tiny_transfer_model(),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(no_card, name):
    with pytest.raises(RuntimeError, match="device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("command", ["import-tf", "export-tf"])
def test_tf_subcommands_name_the_missing_package(monkeypatch, tmp_path, command):
    """Without TensorFlow, import-tf and export-tf exit with a message that
    names it (a refusal: nothing else converts the models)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(SystemExit, match="'tensorflow' package"):
        cli.main([command, str(tmp_path / "in"), str(tmp_path / "out"), "--device", "cpu"])


def test_cpu_entry_points_run_without_a_card(no_card, tmp_path):
    for mode in ("exact", "fast"):
        feats = micro_torch.MicroFrontendTorch(device="cpu", mode=mode).features(np.zeros(16000, np.float32))
        assert tuple(feats.shape) == (49, 40)
    wav = tmp_path / "clip.wav"
    write_wav(wav, np.zeros(16000, np.float32))
    assert dataset.file2spec(_SETTINGS, wav, device="cpu").shape == (49, 40)
    assert evaluate.featurize_files([str(wav)], device="cpu").shape == (1, 49, 40)


def test_chip_smoke_exits_nonzero_without_a_card(tmp_path):
    """Run here (no card) and alone in a directory, it must fail and print
    no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=script.parent, capture_output=True, text=True,
            timeout=120,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("entry", [dscnn.DSCNN, wav2vec2_embed.Wav2Vec2Embedder, steps.make_finetune_epoch_scan,
                                   pretrain.build_fused_resident_epoch, bench.main, graft_entry.entry,
                                   graft_entry.dryrun_multichip, tutorial.run_tutorial], ids=lambda e: e.__name__)
def test_new_model_entry_points_default_to_the_card(entry):
    import inspect

    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_dscnn_runs_on_the_cpu_without_a_card(no_card):
    probs = dscnn.DSCNN(3, filters=8, num_blocks=1, device="cpu").eval()(torch.zeros(2, 49, 40, 1))
    assert tuple(probs.shape) == (2, 3)
