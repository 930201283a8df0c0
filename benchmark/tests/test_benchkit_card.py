"""On the card: every cell runs end to end with ``correct`` true, and the
control (the reference in float8 in the system's place) fails a number.
They skip without a card."""
import json
import subprocess
import sys

import pytest
import torch

import tiny

CELLS = ["g1.train", "g1.serve", "adressa.serve", "g1.eval"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _python(*args):
    out = subprocess.run([sys.executable, *args], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(workload, traced):
    _card()
    line = _python("benchmark/run.py", "--workload", workload, "--seed", "4000000007",
                   "--seconds", "3", "--trace", str(traced))[-1]
    assert line["correct"] is True, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload):
    _card()
    limits = tiny.spec.cell(workload).limits
    for line in _python("benchmark/control.py", "--workload", workload, "--seeds",
                        "4000000011", "--seconds", "3"):
        assert all(v <= limits[k] for k, v in line["system"].items()), line
        assert any(v > limits[k] for k, v in line["control"].items()), line
