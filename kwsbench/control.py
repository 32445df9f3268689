"""Readings that set the limits of a cell's compared numbers, on the card.

    python -m kwsbench.control --workload CELL --seeds S1,S2,... --seconds S --mode MODE

- ``sound``: the cell as the configuration states it, one seed after
  another in this process (the lower readings);
- ``tf32``: the control for float32 with TF32 off, the precision next below:
  the reference computed in TF32 put in the program's place, against the
  reference in float32 (``drivers/<driver>.py``'s ``tf32_readings``);
- ``bf16``: the program's own bfloat16 path (``compute_dtype``) in place
  of float32, run as a cell;
- ``faults``: for a training cell, the loss over half of the batch planted
  in the reference put in the program's place (``fault_readings``);
- ``planted``: for a training cell, one clip's features altered in each
  batch where the program's transform produces them, run as a cell;
- ``setup``: the cell's check on what set-up recorded, without a window
  (for a training cell, set-up's warm call).

Each seed prints one JSON line: the checks' numbers and the run's result.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from kwsbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kwsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", choices=("sound", "tf32", "bf16", "faults", "planted", "setup"), required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "planted":
        plant_altered_features()
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode in ("tf32", "faults", "setup"):
            parts = run.resolve(args.workload)
            driver = parts["driver"]
            read = {"tf32": driver.tf32_readings, "faults": driver.fault_readings,
                    "setup": lambda cell, st: driver.check(cell, st, {})}[args.mode]
            with tempfile.TemporaryDirectory(prefix="kwsbench-") as workdir:
                cell = run.Cell(args.workload, parts["workload"], parts["config"], seed, args.seconds, False,
                                args.device, Path(workdir), run.Spans(), run.Tracer(False))
                out = {"seed": seed, "mode": args.mode, "readings": read(cell, driver.setup(cell))}
        else:
            over = {"config": {"compute_dtype": "bfloat16"}} if args.mode == "bf16" else {}
            res = run.run_cell(args.workload, seed, args.seconds, False, args.device, overrides=over)
            out = {"seed": seed, "mode": args.mode, "checks": res["checks"], "correct": res["correct"],
                   "metrics": res["metrics"]}
        print(json.dumps(out, default=float), flush=True)
    return 0


def plant_altered_features() -> None:
    """One clip's features in every training batch altered (+1 on every
    value) where the program's transform produces them."""
    from multilingual_kws_tpu_torch.data import dataset

    featurize = dataset.augment_featurize

    def altering(*args, **kw):
        specs = featurize(*args, **kw).clone()
        specs[0] += 1.0
        return specs

    dataset.augment_featurize = altering


if __name__ == "__main__":
    sys.exit(main())
