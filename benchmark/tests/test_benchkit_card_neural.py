"""On the card(s): ``gru4rec.train`` runs end to end with ``correct`` true,
traced and not, and its control (the reference in bfloat16 in the system's
place) fails a number; ``g1.dp4.train`` runs correct on four cards.  They
skip without the cards."""
import json
import subprocess
import sys

import pytest
import torch

import tiny


def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA card(s)")


def _python(*args):
    out = subprocess.run([sys.executable, *args], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload, cards", [("gru4rec.train", 1), ("g1.dp4.train", 4)])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(workload, cards, traced):
    _cards(cards)
    line = _python("benchmark/run.py", "--workload", workload, "--seed", "4000000007",
                   "--seconds", "3", "--trace", str(traced))[-1]
    assert line["correct"] is True, line["checks"]


@pytest.mark.cuda
def test_gru4rec_control_fails_on_the_card():
    _cards(1)
    limits = tiny.spec.cell("gru4rec.train").limits
    for line in _python("benchmark/control.py", "--workload", "gru4rec.train", "--seeds",
                        "4000000011", "--seconds", "2", "--precision", "bf16"):
        assert all(v <= limits[k] for k, v in line["system"].items()), line
        assert any(v > limits[k] for k, v in line["control"].items()), line
