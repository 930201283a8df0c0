"""The harness finds configurations, traffic mixes, limits, drivers and
metric readers by name; a new cell is new files and entries only."""
import json
import shutil

import pytest
import torch

import tiny
from benchkit import drivers, spec

BENCH = spec.benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_pieces(workload):
    cell = spec.cell(workload, BENCH)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                      if w["name"] == workload)
    drv = drivers.driver(cell.traffic["driver"])
    for fn in ("setup", "window", "reference_outputs", "system_outputs", "as_system",
               "numbers", "free"):
        assert callable(getattr(drv, fn))
    assert cell.limits, "every cell states its limits"
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(m["moves"] in e2e for m in cell.per_layer)


def test_a_new_cell_needs_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    mix = spec.load_json(spec.BENCH_DIR / "traffic" / "serve_b32.json")
    mix["batch_sessions"] = 64
    (root / "benchmark" / "traffic" / "serve_b64.json").write_text(json.dumps(mix))
    (root / "benchmark" / "metrics" / "candidates_per_call.py").write_text(
        "def read(run):\n    return run.work.get('candidates')\n")
    (root / "benchmark" / "limits" / "g1.serve_b64.json").write_text(
        (spec.BENCH_DIR / "limits" / "g1.serve.json").read_text())
    bench["workloads"].append({"name": "g1.serve_b64", "config": "g1", "traffic": "serve_b64",
                               "chips": 1, "why": "smaller requests"})
    bench["per_layer"].append({"name": "candidates_per_call", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "Serving entry",
                               "moves": "recommend_p95_ms", "workloads": ["g1.serve_b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("g1.serve_b64", spec.benchmark(root), root / "benchmark")
    assert cell.traffic["batch_sessions"] == 64
    assert [m["name"] for m in cell.per_layer] == ["candidates_per_call"]
    reader = spec.metric_reader("candidates_per_call", root / "benchmark")
    run = tiny.tiny_run("g1.serve", 3, tmp_path)
    run.traffic = dict(run.traffic, batch_sessions=5)
    import run as bench_run  # benchmark/run.py
    bench_run.execute(run, torch.device("cpu"), drivers.driver(cell.traffic["driver"]))
    assert reader(run) == run.traffic["num_candidates"]
    assert all(c.ok for c in run.checks.values())
