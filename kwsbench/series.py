"""Run cells several times, each run a fresh process, and summarize.

    python -m kwsbench.series --out DIR --runs CELL:SEED:SECONDS:TRACE ...

Each run's standard output and error go to
``DIR/<cell>.<seed>.<trace>.<run's place in the list>.{out,err}``,
its result line to ``DIR/results.jsonl``. At the end it prints, for each
cell and metric, the runs' values, the median and the spread (the distance
between the first and third quartiles of ``statistics.quantiles(n=4)``, as a
share of the median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kwsbench.series")
    ap.add_argument("--out", required=True)
    ap.add_argument("--runs", nargs="+", required=True, help="CELL:SEED:SECONDS:TRACE")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    values = defaultdict(list)
    for place, run in enumerate(args.runs):
        cell, seed, seconds, trace = run.split(":")
        stem = out / f"{cell}.{seed}.{trace}.{place}"
        t0 = time.time()
        with open(f"{stem}.out", "w") as so, open(f"{stem}.err", "w") as se:
            rc = subprocess.call([sys.executable, "-m", "kwsbench", "--workload", cell, "--seed", seed,
                                  "--seconds", seconds, "--trace", trace], stdout=so, stderr=se)
        wall = time.time() - t0
        lines = Path(f"{stem}.out").read_text().strip().splitlines()
        res = None
        if rc == 0 and lines:
            try:
                res = json.loads(lines[-1])
            except json.JSONDecodeError:
                res = None
        rec = {"cell": cell, "seed": int(seed), "seconds": float(seconds), "trace": int(trace), "rc": rc,
               "wall_s": wall, "result": res}
        with open(out / "results.jsonl", "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        tail = Path(f"{stem}.err").read_text()[-1500:]
        print(f"== {cell} seed {seed} trace {trace}: rc {rc}, {wall:.1f} s", flush=True)
        if res is None:
            print(tail, flush=True)
            continue
        print(json.dumps({k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device", "checks")}),
              flush=True)
        if "breakdown" in res:
            print(json.dumps(res["breakdown"])[:1500], flush=True)
        for k, m in res["metrics"].items():
            values[(cell, int(trace), k)].append(m["value"])
    print("== summary (cell, trace, metric: n, median, spread, values)")
    for (cell, trace, k), v in values.items():
        print(f"{cell} {trace} {k}: n {len(v)} median {statistics.median(v)!r} spread {spread(v)!r} {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
