"""The port's benchmark program (``multilingual_kws_tpu_torch/bench.py``) on
the CPU at tiny sizes: its JSON line, its preflight (which passes on the
plain versions and fails, exit 1 and value 0.0, when one is off by a grid
step or an int16 step), its copy of ``bench.py``'s corpus clip, its FLOP
count against torch's own counter, its read-only baseline, and each extra
metric at a tiny size. CPU runs time the CPU, so no number here is a
device number: the line's ``mfu`` is null.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multilingual_kws_tpu_torch import bench
from multilingual_kws_tpu_torch.ops import cuda_augment, cuda_clip, cuda_frontend

REPO = Path(__file__).resolve().parents[1]
TINY = {"device": "cpu", "batch": 2, "target_s": 0.01, "preflight_clips": 8}
TINY_TRUNK = {"width_coefficient": 0.25, "depth_coefficient": 0.1}
KEYS = {"metric", "value", "unit", "vs_baseline", "bit_exact_on_chip", "model_compute_dtype", "f32_clips_per_sec",
        "bf16_clips_per_sec", "baseline_clips_per_sec", "baseline_age_days", "baseline_provenance",
        "flops_per_clip", "mfu", "device"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_prints_one_line_with_every_key(capsys):
    assert bench.main([], **TINY) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert KEYS <= set(line), KEYS - set(line)
    assert line["bit_exact_on_chip"] is True and line["unit"] == "clips/sec"
    assert line["value"] == max(line["f32_clips_per_sec"], line["bf16_clips_per_sec"])
    assert line["model_compute_dtype"] in ("float32", "bfloat16")
    assert line["device"] == {"name": "cpu", "power_limit_w": None, "count": 0}
    assert line["mfu"] is None  # no device peak for a CPU run
    assert line["flops_per_clip"] == bench.flops_per_clip(bench.embedding_model("float32", "cpu"))
    assert line["vs_baseline"] == pytest.approx(line["value"] / line["baseline_clips_per_sec"], rel=1e-2)


def _off_by_one_grid_step(monkeypatch):
    plain = cuda_clip.clip_features_plain
    monkeypatch.setattr(cuda_clip, "clip_features_plain",
                        lambda audio, fe, scaled=True: plain(audio, fe, scaled) + cuda_frontend.FEATURE_SCALE)


def _suffix_off_by_one(monkeypatch):
    plain = cuda_frontend.stream_suffix_plain
    monkeypatch.setattr(cuda_frontend, "stream_suffix_plain",
                        lambda base, n, stride, frames, fe, scaled=True: plain(base, n, stride, frames, fe, scaled) + 1)


def _augment_two_steps_off(monkeypatch):
    kernel = cuda_augment.augment_quantize
    monkeypatch.setattr(cuda_augment, "augment_quantize", lambda *a: kernel(*a) + 2)


@pytest.mark.parametrize("fault", [_off_by_one_grid_step, _suffix_off_by_one, _augment_two_steps_off],
                         ids=["clip_features", "stream_suffix", "augment_quantize"])
def test_preflight_failure_prints_the_failure_line_and_exits_1(monkeypatch, capsys, fault):
    fault(monkeypatch)
    assert bench.main([], **TINY) == 1
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0 and line["bit_exact_on_chip"] is False
    assert "error" in line and "PREFLIGHT FAILED" in captured.err


def test_preflight_passes_on_the_plain_versions():
    assert bench.preflight_bit_exact_on_chip(8, device="cpu")


def test_tone_clip_is_bench_py_s_bitwise():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    for freq, seed in ((440.0, 0), (1200.0, 7), (300.0 + 45 * 3, 305), (980.0, 2**31 + 5)):
        want = root._tone_clip(freq, seed=seed)
        got = bench.tone_clip(freq, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_flops_per_clip_matches_torch_s_flop_counter():
    """The full-width B0 761-way model: the count from the layers' shapes
    against FlopCounterMode's count of its convolutions and dense layers
    (the only operations it counts in this model) at batch 1."""
    model = bench.embedding_model("float32", "cpu")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 49, 40, 1))
    counted = counter.get_flop_counts()["Global"]
    assert {str(op) for op in counted} == {"aten.convolution", "aten.addmm"}
    assert bench.flops_per_clip(model) == counter.get_total_flops()
    assert 5e7 < counter.get_total_flops() < 6e7


def test_get_baseline_reads_the_cache_and_writes_nothing(monkeypatch, tmp_path):
    cache = REPO / "benchmarks" / "ref_baseline.json"
    before = (cache.read_bytes(), cache.stat().st_mtime_ns)
    base = bench.get_baseline()
    assert (cache.read_bytes(), cache.stat().st_mtime_ns) == before
    assert base["clips_per_sec"] == json.loads(before[0])["clips_per_sec"]
    assert base["age_days"] >= 0 and "not re-measured" in base["provenance"]
    monkeypatch.setattr(bench, "BASELINE_CACHE", tmp_path / "missing.json")
    missing = bench.get_baseline()
    assert np.isnan(missing["clips_per_sec"]) and missing["provenance"] == "unavailable"
    assert not (tmp_path / "missing.json").exists()


def test_chained_time_feeds_each_output_into_the_next_call():
    seen = []

    def step(x, eps):
        seen.append(float(eps))
        return eps + 1.0

    per_iter = bench.chained_time(step, torch.zeros(3), target_s=0.0)
    # one warm-up call, a 4-call estimate, then at least 12 chained calls
    assert per_iter > 0 and len(seen) == 1 + 4 + 12
    assert seen[1:5] == [0.0, 1.0, 2.0, 3.0] and seen[5:] == [float(i) for i in range(12)]


def test_extra_metrics_run_at_a_tiny_size(tmp_path):
    parts = bench.measure_decomposition(batch=2, target_s=0.01, device="cpu")
    assert [p["unit"] for p in parts] == ["clips/sec"] * 3
    assert parts[1]["mfu_vs_f32_peak"] is None and parts[2]["mfu_vs_bf16_peak"] is None
    lat = bench.measure_realtime_latency(device="cpu", chunks_ms=(100,), **TINY_TRUNK)
    assert len(lat["chunk_100ms"]) == 3 and lat["chunk_100ms"][0] > 0
    rtf = bench.measure_streaming_rtf(tmp_path / "rtf", device="cpu", num_targets=2, num_distractors=2,
                                      **TINY_TRUNK)
    assert len(rtf["wall_seconds_reps"]) == 3 and rtf["real_time_factor"] > 0
    step = bench.measure_pretrain_step(batch=4, steps=2, reps=1, num_labels=5, device="cpu", **TINY_TRUNK)
    assert step["f32_ms_per_step"] > 0 and step["bf16_ms_per_step"] > 0
    e2e = bench.measure_pretrain_e2e(tmp_path / "e2e", compute_bound=step["f32_clips_per_sec"], words=2, clips=4,
                                     batch=4, steps=2, resident_steps=2, reps=1, num_labels=5, device="cpu",
                                     **TINY_TRUNK)
    assert e2e["stream_sync_clips_per_sec"] > 0 and len(e2e["resident_reps_clips_per_sec"]) == 1
