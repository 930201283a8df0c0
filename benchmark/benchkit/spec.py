"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root,
``configs/<config>.json``, ``traffic/<mix>.json``, ``limits/<workload>.json``
and ``metrics/<metric>.py``.  Adding a configuration, a traffic mix, a
metric or a cell is adding files and entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    traffic_name: str
    chips: int
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics
    limits: Dict[str, float]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str, e2e_of_cell: List[str]) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one without it is every cell's that reports what it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def cell(workload: str, bench: Optional[dict] = None, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = bench if bench is not None else benchmark(bench_dir.parent)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(bench_dir.parent / conf_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, e2e_names)]
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
    return Cell(workload, config, traffic, entry["traffic"], int(entry["chips"]), e2e,
                per_layer, limits)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run holds nothing for it to read."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
