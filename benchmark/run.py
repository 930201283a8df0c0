#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload g1.train --seed 12345 --seconds 20 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs``) and a traffic mix (``benchmark/traffic``), whose
``driver`` (``benchmark/benchkit/drivers``) builds the system under test
(``chameleon_recsys_tpu_torch``) from the seed, warms it up, measures for
``--seconds`` and then decides ``correct`` against the plain reference
(``benchmark/reference``) with the cell's limits (``benchmark/limits``).
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (``benchmark/metrics``), read from a
profiled stretch after the window.  It needs an NVIDIA card and fails
without one, or without the system beside it.
"""
from __future__ import annotations

import argparse
import gc
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / "_bench_cache"


def _environment() -> None:
    """Caches at fixed places inside the checkout; no JAX behind a library;
    one thread for the host's math libraries, so that the one process is
    all the load and no idle worker spins beside it."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(CACHE / "inductor"))
    for p in (str(BENCH_DIR), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def execute(run, device, driver=None):
    """Set up, measure, free the system, then compare against the reference
    in float32 and fill ``run.checks``."""
    import torch

    from benchkit import drivers
    from benchkit.common import Check

    drv = driver or drivers.driver(run.traffic["driver"])
    state = drv.setup(run, device)
    drv.window(run, state, device)
    sys_out = drv.system_outputs(run, state)
    drv.free(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ref_out = drv.reference_outputs(run, state, device)
    state["reference"] = ref_out
    numbers = drv.numbers(run, state, sys_out, ref_out)
    run.host["reference_s"] = time.perf_counter() - t0
    run.checks = {k: Check(float(v), float(run.limits.get(k, math.nan)))
                  for k, v in numbers.items()}
    return state


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def report(run, cell, bench, device_name: str, chips: int) -> str:
    from benchkit import spec
    from benchkit.common import result_line

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            value = run.setup_s if m["name"] == "setup_s" else run.e2e[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    breakdown = None
    if run.trace and run.trace_summary is not None:
        tr = run.trace_summary
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        breakdown = {"device_ops": [[n, s] for n, s in tr.device_ops],
                     "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    return result_line(run, metrics, device, breakdown)


def main(argv=None) -> int:
    _environment()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchkit import spec
    from benchkit.common import Run, forbidden_modules

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} NVIDIA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    power = _power_limit()
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        run = Run(args.workload, args.seed, args.seconds, bool(args.trace), name,
                  cell.config, cell.traffic, cell.limits, tmp)
        try:
            execute(run, device)
            line = report(run, cell, bench, name, cell.chips)
        except Exception:  # noqa: BLE001 - a failed run prints no result
            traceback.print_exc()
            return 1
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {power}; setup {run.setup_s:.3f} s by phase "
          + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items())
          + f"; window {run.window_s:.3f} s; reference {run.host.get('reference_s', 0):.3f} s",
          file=sys.stderr)
    for k, c in run.checks.items():
        print(f"check {k}: {c.value:.6g} (limit {c.limit:.6g}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
