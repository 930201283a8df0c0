"""``g1.dp4.train`` on the CPU: its driver (``train_hours_dp4``) as a
2-rank gloo world at a tiny size.  This process is rank 0, as in the
benchmark's runs, and the driver starts rank 1 (``python -m
benchkit.drivers.train_hours_dp4``).  A sound run is correct, with the
ranks' parameters bit-equal; a rank whose update is left out diverges; a
rank that fails ends the run instead of leaving the other waiting."""
import pytest
import torch

import tiny
import run as bench_run
from benchkit import spec
from benchkit.common import Run
from benchkit.drivers import train_hours_dp4

SEED = 2 ** 31 + 606


def _run(tmp_path, world=2, trace=False, seconds=0.4):
    cell = spec.cell("g1.dp4.train")
    mix = tiny.tiny_traffic("train_hours")
    mix.update(driver="train_hours_dp4", data_parallelism=world, rank_timeout_s=240)
    return Run("g1.dp4.train", SEED, seconds, trace, "cpu", tiny.tiny_config("g1"), mix,
               dict(cell.limits), str(tmp_path))


def test_a_sound_run_is_correct_and_the_ranks_agree(tmp_path):
    run = _run(tmp_path, trace=True)
    state = bench_run.execute(run, torch.device("cpu"))
    assert all(c.ok for c in run.checks.values()), run.checks
    assert run.checks["rank_divergence"].value == 0
    assert set(run.checks) == {"prob_gap", "grad_gap", "change_gap", "row_faults",
                               "negative_faults", "rank_divergence"}
    # the global batch's rows: both ranks' blocks, gathered on rank 0
    assert state["records"][0]["rows"].max() >= 8 * 5 // 2
    assert run.e2e["train_sessions_per_s"] > 0 and run.trace_summary is not None
    assert spec.metric_reader("grad_sync_share.dp4")(run) > 0


def test_a_rank_that_skips_its_update_diverges(tmp_path, monkeypatch):
    """Rank 0 (this process) leaves its parameters and Adam unchanged; rank
    1 updates as it should."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    run = _run(tmp_path)
    bench_run.execute(run, torch.device("cpu"))
    assert run.checks["rank_divergence"].value > 0
    assert not run.checks["rank_divergence"].ok


def test_a_failing_rank_ends_the_run(tmp_path, monkeypatch):
    """Rank 0 fails in its set-up, after the process group formed: the
    run raises and the other rank is ended, not left waiting."""
    started = []
    original = train_hours_dp4._end

    def end(children, timeout=0.0):
        started.extend(p for _, p in children)
        return original(children, timeout)

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(train_hours_dp4, "_end", end)
    monkeypatch.setattr(train_hours_dp4.mesh_system, "make_harness", broken)
    with pytest.raises(RuntimeError, match="planted"):
        bench_run.execute(_run(tmp_path), torch.device("cpu"))
    assert started and all(p.poll() is not None for p in started)


def test_a_taken_port_is_tried_again(tmp_path, monkeypatch):
    """Rank 0's first join finds its free port taken (another process bound
    it first): the driver ends that attempt's ranks and starts again on
    another port."""
    original = train_hours_dp4.mesh_system.join
    calls = []

    def join(*a, **k):
        calls.append(a[0])
        if len(calls) == 1:
            raise RuntimeError("The server socket has failed to listen: EADDRINUSE")
        return original(*a, **k)

    monkeypatch.setattr(train_hours_dp4.mesh_system, "join", join)
    run = _run(tmp_path)
    bench_run.execute(run, torch.device("cpu"))
    assert len(calls) == 2 and all(c.ok for c in run.checks.values()), run.checks
