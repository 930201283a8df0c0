#!/usr/bin/env python3
"""Split the fused scorer's backward (K1b, and K1b' without the stash) by
device launch, on one NVIDIA card.

    python3 scripts/profile_scorer_bwd.py [--calls 5]

Builds ``csrc/cand_score_fwd.cu`` and ``csrc/cand_score_bwd.cu``, makes
random bf16 operands at the compacted G1 train shape (BT 2688, K 50, C 1024,
matching 128/64/32, seeded), times K1b and K1b' with CUDA events, and lists
the device time of every launch of one call in launch order (torch profiler,
device events only, averaged over ``--calls`` calls).  Prints the card's name
and power limit first.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (2688, 50, 1024, 128, 64, 32)  # BT, K, C, M1, M2, M3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_scorer_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chameleon_recsys_tpu_torch.ops.kernels import build, cand_scorer
    from chip_smoke import cuda_ms, launch_split, print_split, ptxas_entries, scorer_inputs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    build.build(["cand_score_fwd", "cand_score_bwd"])
    for entry, registers, spill, smem in ptxas_entries(
            build.build_log.get("cand_score_bwd", "")):
        print(f"  ptxas {entry}: {registers} registers, {spill} bytes spill stores, "
              f"{smem} bytes static smem")

    bt, k = SHAPE[:2]
    ops = scorer_inputs(*SHAPE, dtype=torch.bfloat16, seed=9)
    g = torch.randn(bt, k, generator=torch.Generator().manual_seed(30)).cuda()
    g = g / (bt * 0.1)
    with torch.no_grad():
        _, nc = cand_scorer.cand_score_kernel(*ops, return_nc=True)
        bwd = lambda: cand_scorer.cand_score_bwd_kernel(*ops, nc, g)
        rec = lambda: cand_scorer.cand_score_bwd_recompute_kernel(*ops, g)
        bwd_ms = cuda_ms(bwd, 5, warmup=2)
        rec_ms = cuda_ms(rec, 5, warmup=2)
        print(f"cand_score_bwd {list(ops[0].shape)} bf16: {bwd_ms:.4f} ms (CUDA events, 5 calls)")
        print(f"cand_score_bwd_recompute {list(ops[0].shape)} bf16: {rec_ms:.4f} ms")
        print_split("cand_score_bwd", launch_split(bwd, args.calls))
        print_split("cand_score_bwd_recompute", launch_split(rec, args.calls))
    return 0


if __name__ == "__main__":
    sys.exit(main())
