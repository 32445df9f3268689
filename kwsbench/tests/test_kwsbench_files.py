"""BENCHMARK.json, the cells' files and the shape-derived counts."""

import json
import re

import pytest

from kwsbench import run
from kwsbench.counts import frontend as fcounts
from kwsbench.counts import model as mcounts
from kwsbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
WORKLOADS = sorted(p.stem for p in (ROOT / "kwsbench" / "workloads").glob("*.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "kwsbench"] and BENCH["paths"] == ["kwsbench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moves = {m["name"]: set(m.get("workloads", CELLS)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= moves[m["moves"]]
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", WORKLOADS)
def test_each_workload_file_resolves_its_files_by_name(cell):
    parts = run.resolve(cell)
    wl = parts["workload"]
    assert parts["config"]["name"] == wl["config"] and wl["chips"] == 1 and 1 <= len(wl["why"]) <= 200
    assert set(parts["readers"]) == set(wl["per_layer"]) and wl["end_to_end"] and wl["limits"]
    for f in ("setup", "window", "check"):
        assert callable(getattr(parts["driver"], f))
    assert all(UNIT.match(u) for u in {**wl["end_to_end"], **wl["per_layer"]}.values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_agrees_with_its_workload_file(cell):
    wl = run.resolve(cell)["workload"]
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["config"] == wl["config"] and entry["why"] == wl["why"] and entry["chips"] == wl["chips"]
    listed = {m["name"]: m["unit"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    assert listed == wl["per_layer"]
    e2e = {m["name"]: m["unit"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert e2e == {**wl["end_to_end"], "setup_s": "s"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_files_state_their_cut(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    assert data["width_coefficient"] == data["depth_coefficient"] == 1.0
    assert data["compute_dtype"] == "float32" and data["allow_tf32"] is False


def test_forward_flops_of_the_761_way_b0():
    assert mcounts.forward_flops("classifier", 761) == 53_527_232
    assert mcounts.train_flops("classifier", 761) > 2.9 * mcounts.forward_flops("classifier", 761)


def test_frontend_bounds_at_the_main_paths_shapes():
    samples = 600 * 16000
    assert fcounts.stream_prefix_s(samples) * 1e3 == pytest.approx(0.02525, rel=1e-3)
    assert fcounts.stream_suffix_s(samples, 29950) * 1e3 == pytest.approx(0.09112, rel=1e-3)
    assert fcounts.clip_features_s(64) * 1e3 == pytest.approx(0.002835, rel=1e-3)
    assert fcounts.augment_quantize_s(64) * 1e3 == pytest.approx(0.002446, rel=1e-3)
