#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload g1.serve --seeds 11,12,13 --seconds 4

For each seed it runs the cell as ``run.py`` does (set-up, a short window at
the cell's own load, the comparison), then puts the plain reference in the
system's place computed in float8 (``reference/<name>.py``'s ``fp8``
precision: the nearest precision below the configuration's bfloat16) and
compares that too.  One JSON line a seed: the system's numbers (the lower
readings) and the control's (the upper ones).  The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile

import run as bench_run


def main(argv=None) -> int:
    bench_run._environment()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--precision", default="fp8")
    args = p.parse_args(argv)

    import torch

    from benchkit import drivers, spec
    from benchkit.common import Run

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    drv = drivers.driver(cell.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
            run = Run(args.workload, seed, args.seconds, False, name, cell.config,
                      cell.traffic, cell.limits, tmp)
            state = bench_run.execute(run, device, drv)
            ctrl = drv.reference_outputs(run, state, device, args.precision)
            control = drv.numbers(run, state, drv.as_system(run, state, ctrl),
                                  state["reference"])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "system": {k: c.value for k, c in run.checks.items()},
                              "control": control, "precision": args.precision}), flush=True)
            del state, ctrl
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
