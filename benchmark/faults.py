#!/usr/bin/env python3
"""Readings of a cell's numbers with a fault planted under its timed path,
on the card, at the cell's own size: the upper readings a training cell's
limits are also held against.

    python3 benchmark/faults.py --workload g1.train --fault half_batch --seeds 1,2,3

Faults: ``half_batch`` (each step sees the first half of its sessions, its
mean taken over them), ``altered_update`` (each step's update moves
``CAR_kernel`` by 1e-3 more), ``unchanged_state`` (no step changes the
parameters or Adam).  One JSON line a seed.  The benchmark's runs do not
run this; ``benchmark/tests/test_benchkit_faults.py`` plants the same
faults on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

import run as bench_run


def _plant(fault: str):
    import torch

    from chameleon_recsys_tpu_torch.train import temporal

    original = temporal.train_step

    def half_batch(state, batch, *a, **k):
        batch = dict(batch)
        size = batch["session_size"].clone()
        size[size.shape[0] // 2:] = 0
        batch["session_size"] = size
        return original(state, batch, *a, **k)

    def altered_update(state, *a, **k):
        state, metrics = original(state, *a, **k)
        with torch.no_grad():
            state.model.CAR_kernel.add_(1e-3)
        return state, metrics

    if fault == "unchanged_state":
        torch.optim.Adam.step = lambda self, closure=None: None
    else:
        temporal.train_step = {"half_batch": half_batch, "altered_update": altered_update}[fault]


def main(argv=None) -> int:
    bench_run._environment()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True,
                   choices=("half_batch", "altered_update", "unchanged_state"))
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from benchkit import spec
    from benchkit.common import Run

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    _plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
            run = Run(args.workload, seed, args.seconds, False, torch.cuda.get_device_name(0),
                      cell.config, cell.traffic, cell.limits, tmp)
            bench_run.execute(run, device)
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                              "numbers": {k: c.value for k, c in run.checks.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
