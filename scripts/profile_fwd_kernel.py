#!/usr/bin/env python3
"""Where the scorer forward's bf16 kernel (K1f, ``cand_score_fwd_tc``) spends
its cycles, on one NVIDIA card.

    python3 scripts/profile_fwd_kernel.py [--shape BT K C M1 M2 M3 ...]

Copies ``csrc/cand_score_fwd.cu`` with ``clock64()`` reads added by thread 0
of each consumer warpgroup (at its start, at the end of its tile loop and
at its end; summed over its tiles: forming pre and waiting for it, the CAR
product, the part of it spent waiting for car_W stages, the elementwise
epilogues and W1 folds by 64-column half, and the part of them spent waiting for W1)
and by the producer (when it has issued its last ring stage),
builds the copy with the package's ``nvcc`` flags into a temporary
directory inside the checkout, runs the eval forward at the G1 eval shape
(or at each ``--shape``: a grid of fewer blocks than the card has SMs shows
what a block takes alone; seeded operands, as ``chip_smoke.py`` makes
them) and prints the mean cycles of each phase
over the blocks, with the card's name, power limit and SM clock, and what
ptxas says of the copy's wgmma pipeline.  The
instrumented copy is a measurement aid: the package never builds it.
Exits 1 without a card; fails loudly if the source no longer has the
places it instruments.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4864, 50, 1024, 128, 64, 32)  # BT, K, C, M1, M2, M3
BLOCKS = 4096  # blocks whose clocks are kept
SLOTS = 20  # per block: 8 for each consumer warpgroup, then the producer's
NAMES = ("loading and forming pre", "CAR products", "  of which waiting for car_W",
         "halves (tanh, prod, W1 fold, nc)", "  of which waiting for W1",
         "loop end to warpgroup end")


def instrumented(src: str) -> str:
    """The source with the clock reads added (see the module docstring)."""
    def insert(anchor, text, at=None):
        """``text`` into the source at offset ``at`` of the one ``anchor``
        (default: after it; 0: before it)."""
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_fwd_kernel: anchor not found once: {anchor!r}")
        i = src.index(anchor) + (len(anchor) if at is None else at)
        src = src[:i] + text + src[i:]

    keep = "t_in == 0 && blockIdx.x < 4096"
    clk = f"(g_clk + blockIdx.x * {SLOTS} + 8 * wg)"
    wait_car = "      sm90::mbar_wait(full(wg * S + ri % S), (ri / S) & 1);\n"
    wait_w1 = wait_car
    insert("namespace {\n", f"__device__ long long g_clk[{SLOTS} * {BLOCKS}];\n", at=0)
    insert("  // pre = [d] leaky(i + u), in place over the TMA-loaded i_rows, k-block by\n",
           "  long long c_start = clock64(), c_pre, c_car = 0, c_wait = 0, c_half = 0, "
           "c_hwait = 0, t0, w0;\n", at=0)
    insert("  sm90::fence_proxy_async();\n  sm90::named_sync(1, kConsumers);\n",
           "  c_pre = clock64() - c_start;\n")
    insert("    // acc = pre @ car_W[:, tile]\n", "    t0 = clock64();\n", at=0)
    insert(wait_car + "      const uint32_t b_tile", "      w0 = clock64();\n", at=0)
    insert(wait_car + "      const uint32_t b_tile", "      c_wait += clock64() - w0;\n",
           at=len(wait_car))
    insert(wait_w1 + "      const int h0", "      w0 = clock64();\n", at=0)
    insert(wait_w1 + "      const int h0", "      c_hwait += clock64() - w0;\n",
           at=len(wait_w1))
    insert("    // per 64-column half h: nc", "    c_car += clock64() - t0;\n    t0 = clock64();\n",
           at=0)
    insert("      if (t_in == 0) sm90::mbar_arrive(empty(wg * S + ri % S));\n    }\n  }\n",
           "    c_half += clock64() - t0;\n", at=len("      if (t_in == 0) sm90::mbar_arrive("
                                                "empty(wg * S + ri % S));\n    }\n"))
    insert("  // ---- the tail: x1 = warpgroup 0's partial",
           f"  if ({keep}) {{ {clk}[0] = c_start; {clk}[1] = c_pre; {clk}[2] = c_car; "
           f"{clk}[3] = c_wait; {clk}[4] = c_half; {clk}[5] = c_hwait; "
           f"{clk}[6] = clock64(); {clk}[7] = clock64(); }}\n", at=0)
    insert("  if (wg == 1) return;\n", f"  long long* end_clk = {clk} + 7;\n")
    insert("  if (lane % 4 == 0) {\n    if (in_a) p.out[row_a] = sum[0];",
           f"  if ({keep}) *end_clk = clock64();\n", at=0)
    insert("    // W2 and W3 into the tail",
           f"    if (blockIdx.x < {BLOCKS}) g_clk[blockIdx.x * {SLOTS} + 16] = clock64();\n",
           at=0)
    return src + ('\nextern "C" int read_clk(void* host) {\n'
                  "  return cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));\n}\n")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", type=int, nargs=6, action="append",
                        metavar=("BT", "K", "C", "M1", "M2", "M3"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_fwd_kernel: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chameleon_recsys_tpu_torch.ops.kernels import build, cand_scorer
    from chip_smoke import scorer_inputs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip())
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".profile_") as tmp:
        src, lib_path = Path(tmp) / "cand_score_fwd_clocked.cu", Path(tmp) / "clocked.so"
        src.write_text(instrumented((build.CSRC / "cand_score_fwd.cu").read_text()))
        log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                              str(lib_path), str(src)], capture_output=True, text=True)
        if log.returncode:
            raise RuntimeError(f"profile_fwd_kernel: nvcc failed\n{log.stdout}{log.stderr}")
        for line in (log.stdout + log.stderr).splitlines():
            if "wgmma" in line or "Performance" in line:
                print(f"  ptxas: {line.strip()[:240]}")
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.cand_score_fwd
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        cand_scorer._library = lambda: fn  # this process only
        for shape in args.shape or [SHAPE]:
            ops = scorer_inputs(*shape, dtype=torch.bfloat16, seed=6)
            with torch.inference_mode():
                for _ in range(3):  # the last launch's clocks are read
                    out = cand_scorer.cand_score_kernel(*ops)
                ref = cand_scorer.cand_score_reference(*ops)
            torch.cuda.synchronize()
            clk = np.zeros(SLOTS * BLOCKS, dtype=np.int64)
            if lib.read_clk(clk.ctypes.data_as(ctypes.c_void_p)):
                raise RuntimeError("profile_fwd_kernel: reading the clocks failed")
            _report(shape, ops[0].shape[0], clk, (out - ref).abs().max().item())
    return 0


def _report(shape, n, clk, err):
    blocks = min(-(-n // 64), BLOCKS)
    t = clk.reshape(BLOCKS, SLOTS)[:blocks].astype(np.float64)
    print(f"BT,K,C,M1,M2,M3={tuple(shape)}: {blocks} blocks of 64 rows; the instrumented "
          f"copy's scores against the twin: max error {err:.3e}")
    for wg in (0, 1):
        w = t[:, 8 * wg: 8 * wg + 8]
        phases = (w[:, 1], w[:, 2], w[:, 3], w[:, 4], w[:, 5], w[:, 7] - w[:, 6])
        print(f"  warpgroup {wg}: {(w[:, 7] - w[:, 0]).mean():.0f} cycles a block (mean)")
        for name, cycles in zip(NAMES, phases):
            print(f"    {name:30s} {cycles.mean():9.0f} cycles")
    print(f"  the producer issued its last ring stage "
          f"{(t[:, 16] - t[:, 0]).mean():.0f} cycles after warpgroup 0's start")


if __name__ == "__main__":
    sys.exit(main())
