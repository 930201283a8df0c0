#!/usr/bin/env python3
"""How close the fused scorer's float32 kernels and their plain twins come
to exact arithmetic, on one NVIDIA card.

    python3 scripts/scorer_f32_accuracy.py

At the card tests' 256-row f32 shape (BT 256, K 50, C 1024, matching
128/64/32, seeded operands, as ``tests/test_torch_cuda.py``) and at the
quality example B's (BT 352): the CAR output nc of the split-TF32 stash
forward and of the plain twin (cuBLAS's f32 product, TF32 off), each
against nc from a float64 product rounded to f32 (max and rms error); then,
by ``chip_smoke.close_normwise`` at 2e-4 (normwise error, elements off),
the twin backward on that exact nc against the twin's own recompute, and
the recompute kernel against the twin on the kernel's nc.  Prints the
card's name and power limit first.  Exits 1 without a card.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"card tests": (256, 50, 1024, 128, 64, 32), "B": (352, 50, 1024, 128, 64, 32)}


def main() -> int:
    if not torch.cuda.is_available():
        print("scorer_f32_accuracy: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer
    from chip_smoke import SCORER_GRADS, close_normwise, scorer_inputs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False

    def verdict(got, want):
        worst = max(((close_normwise(a, b, 2e-4), name)
                     for name, a, b in zip(SCORER_GRADS, got, want)),
                    key=lambda item: item[0][2])
        (ok, _, norm, off), name = worst
        return f"{'within' if ok else 'beyond'} 2e-4 (worst {name}: {norm:.2e}, {off} off)"

    with torch.no_grad():
        for label, (bt, k, c, m1, m2, m3) in SHAPES.items():
            ops = scorer_inputs(bt, k, c, m1, m2, m3, torch.float32, seed=9)
            g = torch.randn(bt, k, generator=torch.Generator().manual_seed(10)).cuda()
            i_rows, u, _, car_w, car_b = ops[:5]
            a0 = (i_rows.view(bt, k, c) + u[:, None, :]).view(bt * k, c)
            pre = torch.where(a0 > 0, a0, 0.2 * a0)
            exact = torch.tanh(pre.double() @ car_w.double() + car_b.double()).float()
            _, twin_nc = cand_scorer.cand_score_reference(*ops, return_nc=True)
            _, kernel_nc = cand_scorer.cand_score_kernel(*ops, return_nc=True)
            for name, nc in (("split-TF32 kernel", kernel_nc), ("plain twin (cuBLAS f32)", twin_nc)):
                err = (nc - exact).abs()
                print(f"{label} {list(ops[0].shape)}: nc of the {name} against the exactly "
                      f"rounded nc: max {err.max().item():.3e}, rms "
                      f"{err.pow(2).mean().sqrt().item():.3e}")
            recompute = cand_scorer.cand_score_bwd_reference(*ops, None, g)
            print(f"{label}: the twin backward on the exact nc against the twin's recompute: "
                  + verdict(cand_scorer.cand_score_bwd_reference(*ops, exact, g), recompute))
            print(f"{label}: the recompute kernel against the twin on the kernel's nc: "
                  + verdict(cand_scorer.cand_score_bwd_recompute_kernel(*ops, g),
                            cand_scorer.cand_score_bwd_reference(*ops, kernel_nc, g)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
