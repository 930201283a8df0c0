#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 15 (ACR in bf16 against f32, on the card
and on its host's CPU, at the published widths) alone on one NVIDIA card,
twice: with cuBLAS's reduced-precision reductions of bf16 products allowed
(PyTorch's default) and with them off.

    python3 scripts/acr_bf16_reductions.py

TF32 is off, as in ``chip_smoke.py``.  A failed check of the phase is
printed (``CHECK FAILED``) and the run goes on, so that both settings are
read; the second run ends with the phase's profiles (device busy time and
operations a step).
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("acr_bf16_reductions: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.check = lambda ok, message: ok or print("CHECK FAILED:", message)
    for allowed in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allowed
        print(f"==== allow_bf16_reduced_precision_reduction {allowed}", flush=True)
        _, profile = chip_smoke.acr_bf16_phase()
        if not allowed:
            profile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
