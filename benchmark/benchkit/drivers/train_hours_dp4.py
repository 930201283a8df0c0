"""Data-parallel train hours: ``train_hours`` over a (data x 1) mesh of
``data_parallelism`` ranks, one process and one card a rank, NCCL between
cards (gloo on the CPU, or where ranks share a card):
``TemporalHarness(mesh_plan=...)`` on every rank, each collating the global
batch and training its block of it.

This process is rank 0 and reports; set-up starts the other ranks as child
processes (``python -m benchkit.drivers.train_hours_dp4 SPEC RANK``), which
join the process group through ``parallel/distributed.py`` and make the
same articles, hours, weights and harness from the seed.  Every rank drives
the first steps as ``train_hours`` does, recording its own block's rows,
negatives and probabilities; rank 0 gathers them into the global batch's,
so that ``correct`` holds the all-reduced first gradient (Adam's first
moments; over the leaves whose reference gradient is no round-off), the
change after 3 steps, the global batch's probabilities, rows
and negatives against the unchanged reference, and counts the parameters'
bits that differ between ranks after those steps (``rank_divergence``).
Before each hour of the window rank 0 tells the others whether one more
comes, a barrier; the rate is the global batch's sessions trained between
the first and the last barrier, on rank 0's clock.  A child whose parent is
gone, or that passes its deadline, exits; rank 0 ends every rank when one
fails."""
from __future__ import annotations

import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List

import torch

from .. import check as ck
from .. import mesh_system, system, trace, traffic, weights
from ..common import Run, process_seconds
from . import train_hours
from .common import batch_lengths, hour_objects, no_gc, reference_module, seeds

BENCH_DIR = Path(__file__).resolve().parents[2]
POLL_S = 0.5
PORT_TRIES = 3


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_device(cuda: bool, rank: int):
    """Rank ``rank``'s card, the ranks spread over the cards there are."""
    return torch.device("cuda", rank % torch.cuda.device_count()) if cuda else torch.device("cpu")


def _backend(cuda: bool, world: int) -> str:
    """NCCL where every rank has a card of its own; else gloo (NCCL refuses
    two ranks on one card)."""
    return "nccl" if cuda and torch.cuda.device_count() >= world else "gloo"


def _rank_setup(run, device, plan):
    """Every rank: the traffic, the weights and the mesh harness; the first
    steps recorded; the rest of the first hour as warm-up."""
    cfg, mix = run.config, run.traffic
    ref = reference_module(cfg)
    t = time.perf_counter()
    model = ref.Model(cfg)
    seed_w, seed_s = seeds(run.seed)
    r_corpus, r_hist, r_hours = traffic.rngs(run.seed, 3)
    corpus = traffic.make_corpus(cfg, r_corpus, mix["item_zipf"])
    n = int(mix["sessions_per_hour"])
    hist = traffic.hour_sessions(corpus, cfg, mix, r_hist, n, -1, 10 ** 9)
    bs = int(cfg["nar"]["batch_size"])
    arrays = [traffic.hour_sessions(corpus, cfg, mix, r_hours, n, h, (h + 1) * 10 ** 7)
              for h in range(int(mix["distinct_hours"]))]
    with no_gc():
        hours = [hour_objects(a) for a in arrays]
    lengths = [batch_lengths(a.lengths, bs) for a in arrays]
    first, second = (int(k) for k in mix["check_steps"])
    steps = [traffic.serving_sessions(arrays[0])[i * bs:(i + 1) * bs]
             for i in range(first + second)]
    del arrays
    t = run.phase("traffic", t)
    w = weights.make_weights(model, seed_w, plan.device)
    t = run.phase("weights", t)
    harness = mesh_system.make_harness(cfg, corpus, w, traffic.history_clicks(hist), seed_s,
                                       plan, run.tmpdir + f"/rank{plan.rank}")
    t = run.phase("system", t)

    records: List[dict] = []
    hook = harness.state.model.register_forward_hook(train_hours._capture(records),
                                                     with_kwargs=True)
    harness.train_hour(hours[0][:first * bs])
    b1 = system.adam_betas(harness)[0]
    grad1 = ck.norms({k: m / (1 - b1) for k, m in system.adam_first_moments(harness).items()})
    harness.train_hour(hours[0][first * bs:(first + second) * bs])
    params = system.parameters(harness)
    change = ck.norms({k: params[k].detach() - w[k] for k in w})
    hook.remove()
    divergence = mesh_system.bits_apart(plan, [params[k] for k in sorted(params)])
    gathered = mesh_system.gather(plan, [{k: v.cpu() for k, v in r.items()} for r in records])
    del w, params
    harness.train_hour(hours[0][(first + second) * bs:])  # warm-up
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)
    run.phase("first steps and warm-up", t)
    state = dict(ref=ref, model=model, corpus=corpus, hist=hist, hours=hours,
                 lengths=lengths, harness=harness, grad1=grad1, change=change,
                 seed_w=seed_w, steps=steps, plan=plan, divergence=divergence)
    if gathered is not None:
        state["records"] = _global(gathered, bs // plan.data_parallelism, model.t,
                                   plan.device)
    return state


def _global(by_rank, block: int, t: int, device) -> List[dict]:
    """Each step's record of the global batch: the ranks' rows (local grid
    rows moved to the rank's block of the global grid), valid flags,
    negatives and probabilities, concatenated in rank order."""
    out = []
    for s in range(len(by_rank[0])):
        parts = [records[s] for records in by_rank]
        out.append({
            "rows": torch.cat([p["rows"] + r * block * t for r, p in enumerate(parts)]).to(device),
            "valid": torch.cat([p["valid"] for p in parts]).to(device),
            "negs": torch.cat([p["negs"] for p in parts]).to(device),
            "probs": torch.cat([p["probs"] for p in parts]).to(device),
        })
    return out


def _hours(state, first_hour: int, more) -> int:
    """Train hour after hour from ``first_hour`` while ``more()`` (called
    after each hour, on every rank) holds; the sessions trained."""
    harness, hours = state["harness"], state["hours"]
    h, sessions = first_hour, 0
    while True:
        hour = train_hours._hour(hours, h)
        harness.train_hour(hour)
        sessions += len(hour)
        h += 1
        if not more():
            return sessions


def _traced(run, state) -> int:
    """The traced hours after the window, on every rank; rank 0 profiles
    them."""
    n_traced = int(run.traffic["trace_hours"])
    start = state["next_hour"]
    left = [n_traced]

    def more():
        left[0] -= 1
        return left[0] > 0

    return _hours(state, start, more) // int(run.config["nar"]["batch_size"])


def _window_rank(run, state, primary: bool):
    plan = state["plan"]
    gc.collect()
    gc.freeze()
    if primary:
        run.setup_s = process_seconds()
    mesh_system.flag(plan, 1)
    w0 = time.perf_counter()
    hours = [0]

    def more():
        hours[0] += 1
        return bool(mesh_system.flag(plan, int(time.perf_counter() - w0 < run.seconds)))

    sessions = _hours(state, 1, more)
    state["next_hour"] = 1 + hours[0]
    if primary:
        run.window_s = time.perf_counter() - w0
        run.attempted = sessions // int(run.traffic["sessions_per_hour"]) * len(
            state["lengths"][0])
        run.e2e["train_sessions_per_s"] = sessions / run.window_s
    if run.trace:
        if primary:
            run.trace_summary = trace.profile(lambda: _traced(run, state), run.tmpdir,
                                              plan.device.type == "cuda")
        else:
            _traced(run, state)
    if primary and plan.device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(plan.device))


# -- rank 0 ------------------------------------------------------------------

def _watch(state):
    """Rank 0's watchdog: a child that exits before the end, or the
    deadline passing, ends every rank (a collective would wait for ever)."""
    def loop():
        while not state["ending"].wait(POLL_S):
            dead = [(r, p.returncode) for r, p in state["children"]
                    if p.poll() is not None and p.returncode != 0]
            late = time.time() > state["deadline"]
            if dead or late:
                why = f"ranks {dead} exited" if dead else "the deadline passed"
                print(f"dp4: ending every rank ({why})", file=sys.stderr, flush=True)
                _end(state["children"])
                os._exit(1)

    threading.Thread(target=loop, daemon=True).start()


def _end(children, timeout: float = 0.0) -> None:
    for _, p in children:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        if p.poll() is None:
            p.kill()
            p.wait()


def _start(run, device, world: int, backend: str):
    """Start ranks 1 .. world - 1 on a free port and join them as rank 0:
    (the guard over the children, rank 0's plan)."""
    port = _free_port()
    deadline = time.time() + float(run.traffic["rank_timeout_s"]) + 2 * run.seconds
    spec = dict(workload=run.workload, seed=run.seed, seconds=run.seconds, trace=run.trace,
                device=run.device, config=run.config, traffic=run.traffic, limits=run.limits,
                tmpdir=run.tmpdir, port=port, backend=backend, world=world,
                cuda=device.type == "cuda", parent=os.getpid(), deadline=deadline)
    path = Path(run.tmpdir) / "dp4_spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(BENCH_DIR), str(BENCH_DIR.parent), os.environ.get("PYTHONPATH", "")]))
    children = [(r, subprocess.Popen(
        [sys.executable, "-m", "benchkit.drivers.train_hours_dp4", str(path), str(r)],
        cwd=str(BENCH_DIR), env=env, stdin=subprocess.DEVNULL, stdout=2))
        for r in range(1, world)]
    guard = dict(children=children, deadline=deadline, ending=threading.Event())
    _watch(guard)
    try:
        plan = mesh_system.join(port, world, 0, backend,
                                _rank_device(device.type == "cuda", 0), world)
    except BaseException:
        guard["ending"].set()
        _end(children)
        raise
    return guard, plan


def setup(run, device):
    world = int(run.traffic["data_parallelism"])
    backend = _backend(device.type == "cuda", world)
    for attempt in range(PORT_TRIES):
        try:
            guard, plan = _start(run, device, world, backend)
            break
        except RuntimeError as err:
            # another process took the free port before rank 0 listened on it
            if "EADDRINUSE" not in str(err) or attempt + 1 == PORT_TRIES:
                raise
    try:
        state = _rank_setup(run, plan.device, plan)
    except BaseException:
        _abandon(guard)
        raise
    state["guard"] = guard
    return state


def _abandon(guard) -> None:
    """After a failure on rank 0: end the other ranks and leave the group."""
    guard["ending"].set()
    _end(guard["children"])
    mesh_system.leave()


def window(run, state, device):
    try:
        _window_rank(run, state, primary=True)
    except BaseException:
        _abandon(state.pop("guard"))
        raise


def free(state):
    """The last barrier, then every rank leaves the group and the children
    exit."""
    guard = state.pop("guard", None)
    if guard is None:
        return
    mesh_system.flag(state["plan"], 0)
    guard["ending"].set()
    mesh_system.leave()
    _end(guard["children"], timeout=60.0)
    state.pop("harness", None)


reference_outputs = train_hours.reference_outputs
as_system = train_hours.as_system
system_outputs = train_hours.system_outputs


def numbers(run, state, sys_out, ref_out):
    """``train_hours``' numbers on the global batch, with ``grad_gap`` over
    the leaves whose reference gradient is no round-off, as ``change_gap``
    takes them: the matching MLP's output bias has a zero gradient (the
    softmax is shift-invariant), and what the ranks all-reduce there is the
    sum of their bfloat16 round-off, which reads up to 1.8 of the median
    leaf's norm on a 4 x 1 mesh; and ``rank_divergence``."""
    out = train_hours.numbers(run, state, sys_out, ref_out)
    out["grad_gap"] = ck.norm_gap(sys_out["grad"], ref_out["grad"],
                                  ck.moving_leaves(ref_out["grad"]))
    out["rank_divergence"] = float(state["divergence"])
    return out


# -- ranks 1 .. world - 1 ----------------------------------------------------

def _child_watch(parent: int, deadline: float) -> None:
    def loop():
        while True:
            time.sleep(POLL_S)
            if os.getppid() != parent or time.time() > deadline:
                os._exit(3)

    threading.Thread(target=loop, daemon=True).start()


def child(spec_path: str, rank: int) -> int:
    import run as bench_run

    bench_run._environment()
    spec = json.loads(Path(spec_path).read_text())
    _child_watch(int(spec["parent"]), float(spec["deadline"]))
    torch.set_num_threads(1)
    device = _rank_device(spec["cuda"], rank)
    if spec["cuda"]:
        torch.cuda.set_device(device)
    run = Run(spec["workload"], int(spec["seed"]), float(spec["seconds"]), bool(spec["trace"]),
              spec["device"], spec["config"], spec["traffic"], spec["limits"], spec["tmpdir"])
    plan = mesh_system.join(int(spec["port"]), int(spec["world"]), rank, spec["backend"],
                            device, int(spec["world"]))
    state = _rank_setup(run, device, plan)
    _window_rank(run, state, primary=False)
    mesh_system.flag(plan, 0)
    mesh_system.leave()
    return 0


if __name__ == "__main__":
    sys.exit(child(sys.argv[1], int(sys.argv[2])))
