"""Run one cell of the benchmark once and print its result line.

    python -m kwsbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

1. Refuse to run without a CUDA card (and as many as the cell asks for):
   exit 2, no result. The measurement never falls back to the CPU.
2. Set-up (``setup_s``: from the process's start to the first timed call):
   the driver draws its traffic and weights from ``--seed``, builds the
   program's objects and warms every shape the window uses.
3. The window: the driver drives the program for ``--seconds`` and returns
   its end-to-end metrics (``--trace 0``). With ``--trace 1`` the driver
   runs the profiler over the stretch it marks and the per-layer readers
   (``metrics/<name>.py``) reduce the trace, the harness's spans and the
   shape-derived counts.
4. The device's peak memory is read, then the driver checks what the timed
   path produced against the plain reference (``reference/``), each number
   beside its limit; ``correct`` is whether every number is within.
5. Exit non-zero, with no result, if JAX or the JAX package was loaded.

The last line of standard output is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from kwsbench.trace import Spans, Tracer

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multilingual_kws_tpu")


def process_start_time() -> float:
    """This process's start on the wall clock (Linux ``/proc``)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.time() - (uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_json(kind: str, name: str) -> Dict:
    with open(ROOT / kind / f"{name}.json") as fh:
        return json.load(fh)


def metric_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``, or, where there is no such file,
    the family's: ``metrics/<the name up to its first dot>.py`` (one reader
    of ``idle_share`` for ``idle_share.scan``, ``idle_share.pretrain``, ...)."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists():
        path = ROOT / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"kwsbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Cell:
    """Everything a driver gets: the cell's files, the run's arguments, the
    device, a scratch directory under ``TMPDIR``, the harness's spans and
    the tracer."""

    name: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    workdir: Path
    spans: Spans
    tracer: Tracer
    counts: Dict[str, Any] = field(default_factory=dict)

    @property
    def traffic(self) -> Dict:
        return self.workload["traffic"]


def resolve(workload: str) -> Dict:
    """A cell's workload, configuration, driver module and metric readers."""
    wl = load_json("workloads", workload)
    return {
        "workload": wl,
        "config": load_json("configs", wl["config"]),
        "driver": importlib.import_module(f"kwsbench.drivers.{wl['driver']}"),
        "readers": {m: metric_reader(m) for m in wl["per_layer"]},
    }


def device_info(torch, cell: Cell, peak: int) -> Dict:
    if cell.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell.workload.get("chips", 1)),
            "memory_peak_bytes": peak}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             started: Optional[float] = None, overrides: Optional[Dict] = None) -> Dict:
    """Set up, run the window, check; the result as a dict. ``overrides``
    {"config": {...}, "traffic": {...}, "limits": {...}} update the
    configuration's, the traffic's and the limits' keys (the tests' tiny
    sizes, a control's compute dtype)."""
    started = process_start_time() if started is None else started
    parts = resolve(workload)
    overrides = overrides or {}
    config = {**parts["config"], **overrides.get("config", {})}
    for key in ("traffic", "limits"):
        parts["workload"][key] = {**parts["workload"][key], **overrides.get(key, {})}
    with tempfile.TemporaryDirectory(prefix="kwsbench-") as workdir:
        cell = Cell(workload, parts["workload"], config, seed, seconds, trace, device, Path(workdir),
                    Spans(trace), Tracer(trace and device != "cpu"))
        return _run(cell, parts, started)


def _run(cell: Cell, parts: Dict, started: float) -> Dict:
    import torch

    device, trace = cell.device, cell.trace
    driver = parts["driver"]
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(cell)
    # set-up's objects out of the collector's way: the window's collections
    # then walk only what the window allocates
    gc.collect()
    gc.freeze()
    setup_s = time.time() - started
    out = driver.window(cell, state)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    result: Dict[str, Any] = {"correct": False, "attempted": int(out["attempted"]), "failed": int(out["failed"])}
    dev = device_info(torch, cell, peak)
    if trace:
        summary = cell.tracer.summary
        metrics = {}
        for name, read in parts["readers"].items():
            value = read(summary, cell.spans, cell.counts)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit_of(cell.workload, name)}
        result["metrics"] = metrics
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
    else:
        metrics = {k: {"value": v, "unit": unit_of(cell.workload, k)} for k, v in out["metrics"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        result["metrics"] = metrics
    result["device"] = dev
    if trace and cell.tracer.summary is not None:
        result["breakdown"] = cell.tracer.summary.breakdown()
    if out.get("work"):
        result["work"] = out["work"]
    gc.unfreeze()
    checks = driver.check(cell, state, out)
    result["correct"] = bool(checks) and all(c["ok"] for c in checks.values()) and result["failed"] == 0
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def unit_of(workload: Dict, metric: str) -> str:
    """The unit the cell's workload file gives the metric."""
    return "s" if metric == "setup_s" else {**workload["end_to_end"], **workload["per_layer"]}[metric]


def main(argv) -> int:
    started = process_start_time()
    ap = argparse.ArgumentParser(prog="python -m kwsbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = int(load_json("workloads", args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kwsbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started)
    loaded = forbidden_modules()
    if loaded:
        print(f"kwsbench: JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False, default=_plain), flush=True)
    return 0


def _plain(x):
    """numpy scalars as Python numbers."""
    if hasattr(x, "item"):
        return x.item()
    raise TypeError(type(x))
