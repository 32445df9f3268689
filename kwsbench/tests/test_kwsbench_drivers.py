"""Each driver on the CPU at a tiny size: one short window on the kernels'
plain versions, and the result line the harness builds from it. The
command itself refuses to run without a card."""

import json
import subprocess
import sys

import pytest

from kwsbench import run
from kwsbench.tests.conftest import ROOT, SECONDS, TINY

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_window_on_the_cpu_builds_the_result_line(cell):
    res = run.run_cell(cell, 3, SECONDS[cell], False, device="cpu", overrides=TINY[cell])
    # the result line's keys, then what the run did ("work") and the
    # compared numbers, last
    assert [k for k in res if k != "work"] == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    wl = run.resolve(cell)["workload"]
    assert set(res["metrics"]) == set(wl["end_to_end"]) | {"setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(wl["limits"])
    # the detectors have work: a detection check that compares nothing proves nothing
    assert res.get("work", {}).get("detections", 1) > 0 and res.get("work", {}).get("detections_a_stream", 1) > 0
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_window_on_the_cpu_reports_no_device_metric(cell):
    res = run.run_cell(cell, 4, SECONDS[cell], True, device="cpu", overrides=TINY[cell])
    wl = run.resolve(cell)["workload"]
    assert set(res["metrics"]) <= set(wl["per_layer"])
    assert all(not name.startswith(("idle_share", "mfu", "transform_roofline", "stream_frontend_roofline"))
               for name in res["metrics"])
    assert "busy_s" not in res["device"] and "breakdown" not in res


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; from kwsbench.run import main; "
            "sys.exit(main(['--workload', 'scan-b0t3-10min', '--seed', '1', '--seconds', '1', '--trace', '0']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = ("import json, sys; from kwsbench import run; from kwsbench.tests.conftest import TINY; "
            "run.run_cell('scan-b0t3-10min', 5, 0.5, False, 'cpu', overrides=TINY['scan-b0t3-10min']); "
            "print(json.dumps(run.forbidden_modules()))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "optax", "orbax", "multilingual_kws_tpu")


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "multilingual_kws_tpu_torch_probe", sys)
    assert "multilingual_kws_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.probe", sys)
    assert "jax.probe" in run.forbidden_modules()
