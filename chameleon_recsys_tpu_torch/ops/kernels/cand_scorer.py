"""Fused candidate scorer forward: the hand-written CUDA kernel and its twin.

``cand_score_kernel`` replaces the TPU kernel
``chameleon_recsys_tpu/ops/pallas/cand_scorer.py::_fwd_kernel`` (the
``stash_nc=False`` forward of ``cand_score_pallas``).  On a CUDA tensor it
launches ``csrc/cand_score_fwd.cu`` or raises; on a CPU tensor it runs
``cand_score_reference``, the same function in plain PyTorch.

For each candidate row r of ``i_rows`` [BT*K, C], with bt = r // K:

    pre  = leaky(i[r] + u[bt])                  (u has the PreCAR constant)
    nc   = tanh(pre @ car_w + car_b)
    x    = nc * pred[bt]
    x    = leaky(x @ W + b) for the three matching layers
    s[r] = x . w4                               -> scores [BT, K] float32

What bounds it on an H100: at the G1 eval shape (BT 4864, K 50, C 1024,
matching 128/64/32) it does 0.58 TFLOP on 0.5 GB of ``i_rows``, so the
tensor cores bound it.  The kernel keeps a block's PreCAR rows in shared
memory, walks the CAR output in 64-column chunks on the tensor cores (WMMA,
bf16 in, f32 accumulate) and folds each chunk straight into the first
matching layer, so the [N, C] intermediates never reach device memory.  The
source says more.

Numerics are the Pallas kernel's (``_fwd_compute``), not those of the JAX
``cand_score_reference``: ``i + u`` is added in f32, and each activation is
rounded to the input dtype once, after its bias and nonlinearity.  float32
inputs run in full f32 on the CUDA cores (no TF32).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SOURCE = "cand_score_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M1 = 128  # the first matching layer's accumulators live in registers

# Launches of the CUDA kernel in this process; the CPU path does not count.
launches = 0


def _leaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * x)


def cand_score_reference(
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4, alpha=0.2
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: products in f32 on the rounded
    operands, each activation rounded to the input dtype; [BT, K] f32."""
    bt, c = u.shape
    k = i_rows.shape[0] // bt
    d = i_rows.dtype
    pre = _leaky(i_rows.reshape(bt, k, c).float() + u.float()[:, None, :], alpha)
    pre = pre.to(d)
    nc = torch.tanh(pre.float() @ car_w.float() + car_b.float()).to(d)
    x = nc * pred[:, None, :]  # rounded to d, as bf16 * bf16 is
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        x = _leaky(x.float() @ w.float() + b.float(), alpha).to(d)
    return (x.float() * w4.float()).sum(-1)


def _check(i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4):
    if u.dim() != 2 or u.shape[0] == 0:
        raise ValueError(f"u must be [BT, C] with BT >= 1, got {tuple(u.shape)}")
    bt, c = u.shape
    if i_rows.dim() != 2 or i_rows.shape[1] != c or i_rows.shape[0] % bt:
        raise ValueError(
            f"i_rows must be [BT*K, {c}], got {tuple(i_rows.shape)} for BT {bt}"
        )
    m1, m2, m3 = w1.shape[-1], w2.shape[-1], w3.shape[-1]
    expected = {
        "pred": (pred, (bt, c)), "car_w": (car_w, (c, c)), "car_b": (car_b, (c,)),
        "w1": (w1, (c, m1)), "b1": (b1, (m1,)), "w2": (w2, (m1, m2)),
        "b2": (b2, (m2,)), "w3": (w3, (m2, m3)), "b3": (b3, (m3,)),
        "w4": (w4, (m3,)),
    }
    for name, (tensor, shape) in expected.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(tensor.shape)}")
    operands = (i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4)
    if i_rows.dtype not in _DTYPE_CODES or any(
        t.dtype != i_rows.dtype for t in operands
    ):
        raise TypeError("the operands must all be float32 or all bfloat16")
    if any(t.device != i_rows.device for t in operands):
        raise ValueError("the operands must be on one device")
    return operands


def _library():
    lib = build.load(_SOURCE)
    fn = lib.cand_score_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [
            ctypes.c_int
        ] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def cand_score_kernel(
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4, alpha=0.2
) -> torch.Tensor:
    """Fused candidate scores [BT, K] float32 (the w4 bias left out)."""
    global launches
    operands = _check(i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4)
    if i_rows.device.type == "cpu":
        return cand_score_reference(*operands, alpha=alpha)
    if i_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {i_rows.device}")
    for tensor in operands:
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError("the operands must be contiguous and 16-byte aligned")
    bt, c = u.shape
    n_rows = i_rows.shape[0]
    m1, m2, m3 = w1.shape[1], w2.shape[1], w3.shape[1]
    if m1 > _MAX_M1:
        raise ValueError(f"the kernel takes at most {_MAX_M1} first-layer units")
    out = torch.empty(n_rows, dtype=torch.float32, device=i_rows.device)
    if n_rows == 0:
        return out.reshape(bt, 0)
    fn = _library()
    with torch.cuda.device(i_rows.device):
        err = fn(
            *(t.data_ptr() for t in operands), out.data_ptr(),
            n_rows, n_rows // bt, c, m1, m2, m3, _DTYPE_CODES[i_rows.dtype],
            float(alpha), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"cand_score_fwd launch failed: cudaError {err} (1 is a shape the "
            "kernel cannot take, e.g. C too wide for shared memory)"
        )
    launches += 1
    return out.reshape(bt, n_rows // bt)
