#!/usr/bin/env python3
"""Where the scorer backward's row kernel spends its cycles, on one NVIDIA
card.

    python3 scripts/profile_row_kernel.py [--dtype bfloat16]
        [--shape 2688,50,1024,128,64,32]

Copies ``csrc/cand_score_bwd.cu`` with ``clock64()`` reads added by thread 0
of each block (at the kernel's start, after the a1 pass, after a2, before
the dprod pass, at the end; and, summed over both passes, the time waiting
for a chunk's copies, starting the next chunk's copies, forming prod and
the dprod product), builds the copy with the package's ``nvcc`` flags into
a temporary directory inside the checkout, runs the backward once in
``--dtype`` at ``--shape`` (BT, K, C, M1, M2, M3; by default bf16 at the
compacted G1 train shape; the quality example B's f32 step is ``--dtype
float32 --shape 352,50,1024,128,64,32``; seeded operands, as
``scripts/profile_scorer_bwd.py``) and prints the mean cycles of each
phase over the blocks, with the card's name, power limit and SM clock.
The instrumented copy is a measurement aid: the package never builds it.
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
SHAPE = (2688, 50, 1024, 128, 64, 32)  # BT, K, C, M1, M2, M3
SLOTS = 8  # clock values per block
PHASES = ("a1 pass", "x1 and a2", "rest of the tail", "dprod pass")


def _clock(i):
    return (f"  if (threadIdx.x == 0 && blockIdx.x < 4096) "
            f"g_clk[blockIdx.x * {SLOTS} + {i}] = clock64();\n")


def instrumented(src: str) -> str:
    """The source with the clock reads added (see the module docstring)."""
    def insert(anchor, text, before=False):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_row_kernel: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor if before else anchor + text)

    insert("namespace {\n", f"__device__ long long g_clk[{SLOTS} * 4096];\n", before=True)
    insert("  float* stage = a1;  // the dprod chunk, once the tail is done\n", _clock(0))
    insert("  __syncthreads();  // a1 is complete; every stage of the ring is consumed\n",
           _clock(1))
    insert("      x2[at] = from_f32<Scalar>(leaky(a, alpha));\n    }\n  }\n"
           "  __syncthreads();\n", _clock(2))
    insert("  // ---- dprod = [d] da1 @ W1^T per chunk", _clock(3), before=True)
    insert("  const int n_ch = (C + kCh - 1) / kCh;\n",
           "  long long t_wait = 0, t_load = 0, t_prod = 0, t_dprod = 0, t0;\n")
    insert("      cp_async_wait<S - 2>();  // chunk i has landed (this thread's copies)\n",
           "      t0 = clock64();\n", before=True)
    insert("      __syncthreads();         // everyone's; the stage refilled next is free\n"
           "      load_chunk(i + S - 1);\n",
           "      t_load += clock64() - t0;\n      t0 = clock64();\n")
    insert("      __syncthreads();         // everyone's; the stage refilled next is free\n",
           "      t_wait += clock64() - t0;\n      t0 = clock64();\n")
    insert("      const Scalar* wt = w1_tile(s);\n      if constexpr (kTensor) {\n"
           "        const int rt = warp % 4, ct = 2 * (warp / 4);\n",
           "      t_prod += clock64() - t0;\n", before=True)
    insert("    cp_async_wait<S - 2>();\n    __syncthreads();  // chunk i is in;",
           "    t0 = clock64();\n", before=True)
    insert("    __syncthreads();  // chunk i is in; the last chunk's stage reads are done\n",
           "    t_wait += clock64() - t0;\n    t0 = clock64();\n")
    insert("    __syncthreads();  // chunk i is in; the last chunk's stage reads are done\n"
           "    t_wait += clock64() - t0;\n    t0 = clock64();\n    load_chunk(i + S - 1);\n",
           "    t_load += clock64() - t0;\n    t0 = clock64();\n")
    insert("    const Scalar* nct = nc_tile(s);\n", "    t_dprod += clock64() - t0;\n",
           before=True)
    insert("  cp_async_wait<0>();  // leave no copy",
           _clock(4) + "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
           f"    long long* out = g_clk + blockIdx.x * {SLOTS};\n"
           "    out[5] = t_wait; out[6] = t_load; out[7] = t_prod * 1000000 + t_dprod;\n"
           "  }\n", before=True)
    return src + ('\nextern "C" int read_clk(void* host) {\n'
                  "  return cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));\n}\n")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--shape", default=",".join(map(str, SHAPE)))
    args = parser.parse_args()
    shape = tuple(int(v) for v in args.shape.split(","))
    dtype, code, rows = ((torch.bfloat16, 1, 64) if args.dtype == "bfloat16"
                         else (torch.float32, 0, 32))
    if not torch.cuda.is_available():
        print("profile_row_kernel: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chameleon_recsys_tpu_torch.ops.kernels import build, cand_scorer
    from chip_smoke import scorer_inputs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip())
    bt, k, c, m1, m2, m3 = shape
    ops = scorer_inputs(*shape, dtype=dtype, seed=9)
    g = torch.randn(bt * k, generator=torch.Generator().manual_seed(30)).cuda()
    with torch.no_grad():
        _, nc = cand_scorer.cand_score_kernel(*ops, return_nc=True)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".profile_") as tmp:
        src, lib_path = Path(tmp) / "cand_score_bwd_clocked.cu", Path(tmp) / "clocked.so"
        src.write_text(instrumented((build.CSRC / "cand_score_bwd.cu").read_text()))
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                        str(lib_path), str(src)], check=True, capture_output=True,
                       text=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.cand_score_bwd.argtypes = ([ctypes.c_void_p] * 27 + [ctypes.c_longlong]
                                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        lib.cand_score_bwd_scratch_bytes.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6
        lib.cand_score_bwd_scratch_bytes.restype = ctypes.c_longlong
        n = bt * k
        grads = [torch.empty_like(t) for t in ops]
        scratch = torch.empty(lib.cand_score_bwd_scratch_bytes(n, k, c, m1, m2, m3, code),
                              dtype=torch.uint8, device="cuda")
        for _ in range(3):  # the last launch's clocks are read
            err = lib.cand_score_bwd(
                *(t.data_ptr() for t in ops), nc.data_ptr(), g.data_ptr(),
                *(t.data_ptr() for t in grads), scratch.data_ptr(), n, k, c, m1, m2, m3,
                code, 0.2, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cand_score_bwd launch failed: cudaError {err}")
        torch.cuda.synchronize()
        clk = np.zeros(SLOTS * 4096, dtype=np.int64)
        if lib.read_clk(clk.ctypes.data_as(ctypes.c_void_p)):
            raise RuntimeError("profile_row_kernel: reading the clocks failed")
    blocks = min(-(-n // rows), 4096)
    t = clk.reshape(4096, SLOTS)[:blocks].astype(np.float64)
    phases = np.diff(t[:, :5], axis=1).mean(0)
    print(f"row kernel, {blocks} blocks of {rows} rows at {list(ops[0].shape)} {args.dtype}: "
          f"{(t[:, 4] - t[:, 0]).mean():.0f} cycles a block (mean)")
    for name, cycles in zip(PHASES, phases):
        print(f"  {name:18s} {cycles:9.0f} cycles")
    print(f"  over both passes: waiting for copies {t[:, 5].mean():.0f}, starting "
          f"copies {t[:, 6].mean():.0f}, forming prod {(t[:, 7] // 1000000).mean():.0f}, "
          f"the dprod product {(t[:, 7] % 1000000).mean():.0f} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
