#!/usr/bin/env python3
"""Readings of ``gru4rec.train``'s numbers with a fault planted under its
timed path, on the card, at the cell's own size: the upper readings its
limits are held against besides the control's.

    python3 benchmark/faults_gru4rec.py --fault half_batch --seeds 1,2,3

Faults: ``half_batch`` (each step sees the first half of its sessions),
``altered_update`` (each step's update moves every row of ``wy`` by 1e-3
more), ``unchanged_state`` (no step changes the parameters or Adagrad),
``outside_negatives`` (the negatives drawn from every item row, not the
click buffer).  One JSON line a seed.  The benchmark's runs do not run
this; ``benchmark/tests/test_benchkit_gru4rec.py`` plants the same faults
on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

import run as bench_run

FAULTS = ("half_batch", "altered_update", "unchanged_state", "outside_negatives")


def plant(fault: str) -> None:
    import numpy as np
    import torch

    from chameleon_recsys_tpu_torch.baselines import gru4rec

    original = gru4rec.GRU4Rec.fit_batch

    def half_batch(self, items, labels, buffer_ids):
        items, labels = items.copy(), labels.copy()
        items[items.shape[0] // 2:] = 0
        labels[labels.shape[0] // 2:] = 0
        return original(self, items, labels, buffer_ids)

    def altered_update(self, *a):
        loss = original(self, *a)
        with torch.no_grad():
            self.params.wy.add_(1e-3)
        return loss

    def outside_negatives(self, items, labels, buffer_ids):
        return original(self, items, labels, np.arange(1, self.n_items))

    if fault == "unchanged_state":
        gru4rec.ReferenceOptimizer.step = lambda self, closure=None: None
    else:
        gru4rec.GRU4Rec.fit_batch = {"half_batch": half_batch, "altered_update": altered_update,
                                     "outside_negatives": outside_negatives}[fault]


def main(argv=None) -> int:
    bench_run._environment()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="gru4rec.train")
    p.add_argument("--fault", required=True, choices=FAULTS)
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
    plant(args.fault)
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
