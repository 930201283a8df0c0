"""UGRNN forward scan: the hand-written CUDA kernel and its plain twin.

``ugrnn_scan_kernel`` replaces the TPU kernel
``chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py::_fwd_kernel``.  On a CUDA
tensor it launches ``csrc/ugrnn_fwd.cu`` or raises; on a CPU tensor it runs
``ugrnn_scan_reference``, the same function in plain PyTorch.

What bounds it on an H100: the recurrence is a chain of T dependent steps (19
at G1), each a small [rows, U] x [U, 2U] product plus gate math.  At serving
batches that is microseconds of f32 arithmetic and about a megabyte of
traffic, so the time is the latency of the serial chain.  The kernel keeps h
on the SM for the whole sequence (shared memory, f32, double-buffered, one
barrier per step), gives each thread both gate columns of one hidden unit so
the gate math needs no exchange, and reads W_hh from L2 with coalesced loads.
Each block owns two batch rows (``kRows`` in the source).

Numerics follow the Pallas kernel, not ``ops.rnn.ugrnn_scan``: inputs are
widened to f32, h and the gates stay f32 for the whole sequence, and the
output is rounded once to x_proj's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SOURCE = "ugrnn_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_UNITS = 1024  # one thread per hidden unit

# Launches of the CUDA kernel in this process; the CPU path does not count.
launches = 0


def ugrnn_scan_reference(
    x_proj: torch.Tensor,  # [B, T, 2U]
    w_hh: torch.Tensor,  # [U, 2U]
    mask: torch.Tensor,  # [B, T] bool
    forget_bias: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: an f32 time loop, zero h0, output
    in x_proj's dtype."""
    b, t, two_u = x_proj.shape
    units = two_u // 2
    x = x_proj.float()
    w = w_hh.float()
    h = torch.zeros((b, units), dtype=torch.float32, device=x_proj.device)
    outs = []
    for step in range(t):
        acts = x[:, step] + h @ w
        g = torch.sigmoid(acts[:, :units] + forget_bias)
        c = torch.tanh(acts[:, units:])
        h_new = g * h + (1.0 - g) * c
        h = torch.where(mask[:, step, None], h_new, h)
        outs.append(h)
    if not outs:
        return torch.zeros((b, 0, units), dtype=x_proj.dtype, device=x.device)
    return torch.stack(outs, dim=1).to(x_proj.dtype)


def _check(x_proj, w_hh, mask):
    if x_proj.dim() != 3 or x_proj.shape[-1] % 2:
        raise ValueError(f"x_proj must be [B, T, 2U], got {tuple(x_proj.shape)}")
    b, t, two_u = x_proj.shape
    units = two_u // 2
    if tuple(w_hh.shape) != (units, two_u):
        raise ValueError(
            f"w_hh must be [{units}, {two_u}], got {tuple(w_hh.shape)}"
        )
    if tuple(mask.shape) != (b, t) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{b}, {t}]")
    if x_proj.dtype not in _DTYPE_CODES or w_hh.dtype != x_proj.dtype:
        raise TypeError("x_proj and w_hh must both be float32 or both bfloat16")
    if not (x_proj.device == w_hh.device == mask.device):
        raise ValueError("x_proj, w_hh and mask must be on one device")


def _library():
    lib = build.load(_SOURCE)
    fn = lib.ugrnn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def ugrnn_scan_kernel(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    mask: torch.Tensor,
    forget_bias: float = 1.0,
) -> torch.Tensor:
    """UGRNN recurrence with zero h0 given the input projection; [B, T, U]."""
    global launches
    _check(x_proj, w_hh, mask)
    if x_proj.device.type == "cpu":
        return ugrnn_scan_reference(x_proj, w_hh, mask, forget_bias)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    for name, tensor in (("x_proj", x_proj), ("w_hh", w_hh), ("mask", mask)):
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, t, two_u = x_proj.shape
    units = two_u // 2
    if units > _MAX_UNITS:
        raise ValueError(f"the kernel takes at most {_MAX_UNITS} units")
    out = torch.empty((b, t, units), dtype=x_proj.dtype, device=x_proj.device)
    if b == 0 or t == 0:
        return out
    fn = _library()
    with torch.cuda.device(x_proj.device):
        err = fn(
            x_proj.data_ptr(), w_hh.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, t, units,
            _DTYPE_CODES[x_proj.dtype], float(forget_bias),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ugrnn_fwd launch failed: cudaError {err}")
    launches += 1
    return out
