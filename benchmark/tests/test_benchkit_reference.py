"""The plain reference against the system at tiny widths on the CPU,
through each cell's own driver: float32 on both sides agrees to round-off,
and the system's bfloat16 path stays inside the cell's limits."""
import copy

import pytest
import torch

import tiny
import run as bench_run

WORKLOADS = ["g1.train", "g1.serve", "adressa.serve", "g1.eval"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_float32_agrees(workload, tmp_path):
    run = tiny.tiny_run(workload, 2 ** 31 + 101, tmp_path)
    bench_run.execute(run, torch.device("cpu"))
    for name, c in run.checks.items():
        assert c.value <= (0 if name.endswith("faults") else 1e-4), (name, c.value)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_bfloat16_inside_the_limits(workload, tmp_path):
    run = tiny.tiny_run(workload, 2 ** 31 + 202, tmp_path)
    run.config = copy.deepcopy(run.config)
    run.config["nar"].update(compute_dtype="bfloat16", use_pallas_rnn=True,
                             use_pallas_scorer=True)
    bench_run.execute(run, torch.device("cpu"))
    bad = {k: (c.value, c.limit) for k, c in run.checks.items() if not c.ok}
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_system():
    import ast

    for path in (tiny.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("chameleon_recsys_tpu_torch",
                                               "chameleon_recsys_tpu", "jax", "benchkit"), \
                    (path.name, n)
