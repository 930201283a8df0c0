"""UGRNN scan: the hand-written CUDA kernels and their plain twins.

``ugrnn_scan_kernel`` replaces the TPU kernel
``chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py::_fwd_kernel`` and
launches ``csrc/ugrnn_fwd.cu``; ``ugrnn_scan_bwd_kernel`` replaces its
backward ``_bwd_kernel`` (``_bwd_vjp``) and launches ``csrc/ugrnn_bwd.cu``.
On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs its plain twin (``ugrnn_scan_reference``, ``ugrnn_scan_bwd_reference``).
``UGRNNScan`` joins them as an ``autograd.Function``: its forward also keeps
the f32 states, from which the backward recomputes the gates, as the Pallas
VJP keeps its f32 padded output.

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
_BWD_SOURCE = "ugrnn_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_UNITS = 1024  # one thread per hidden unit

# Launches of the CUDA kernels in this process; the CPU path does not count.
launches = 0  # the forward
bwd_launches = 0  # the backward (one per call: the chain and dW_hh)


def ugrnn_scan_reference(
    x_proj: torch.Tensor,  # [B, T, 2U]
    w_hh: torch.Tensor,  # [U, 2U]
    mask: torch.Tensor,  # [B, T] bool
    forget_bias: float = 1.0,
    return_state: bool = False,
):
    """Plain PyTorch twin of the kernel: an f32 time loop, zero h0, output
    in x_proj's dtype; with ``return_state`` also the f32 states."""
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
    if outs:
        hs = torch.stack(outs, dim=1)
    else:
        hs = torch.zeros((b, 0, units), dtype=torch.float32, device=x.device)
    out = hs.to(x_proj.dtype)
    return (out, hs) if return_state else out


def ugrnn_scan_bwd_reference(
    x_proj: torch.Tensor,  # [B, T, 2U]
    w_hh: torch.Tensor,  # [U, 2U]
    mask: torch.Tensor,  # [B, T] bool
    hs: torch.Tensor,  # [B, T, U] f32, the forward's states
    g_out: torch.Tensor,  # [B, T, U] cotangent of the output
    forget_bias: float = 1.0,
):
    """Plain PyTorch twin of the backward kernel, the Pallas ``_bwd_kernel``
    step by step: f32 throughout, the gates recomputed from ``hs``, a masked
    step flowing through the gate and a padded one copying dh.  Returns
    (dx_proj in x_proj's dtype, dW_hh in W_hh's)."""
    b, t, two_u = x_proj.shape
    units = two_u // 2
    x, w, g = x_proj.float(), w_hh.float(), g_out.float()
    dh = torch.zeros((b, units), dtype=torch.float32, device=x.device)
    dx = torch.zeros((b, t, two_u), dtype=torch.float32, device=x.device)
    dw = torch.zeros((units, two_u), dtype=torch.float32, device=x.device)
    for step in reversed(range(t)):
        h_prev = hs[:, step - 1].float() if step > 0 else torch.zeros_like(dh)
        acts = x[:, step] + h_prev @ w
        gate = torch.sigmoid(acts[:, :units] + forget_bias)
        c = torch.tanh(acts[:, units:])
        dh = dh + g[:, step]
        m = mask[:, step, None].to(torch.float32)
        dh_m = dh * m
        da = torch.cat([dh_m * (h_prev - c) * gate * (1.0 - gate),
                        dh_m * (1.0 - gate) * (1.0 - c * c)], dim=-1)
        dx[:, step] = da
        dw += h_prev.T @ da
        dh = dh_m * gate + da @ w.T + dh * (1.0 - m)
    return dx.to(x_proj.dtype), dw.to(w_hh.dtype)


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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _bwd_library():
    lib = build.load(_BWD_SOURCE)
    fn = lib.ugrnn_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def ugrnn_scan_kernel(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    mask: torch.Tensor,
    forget_bias: float = 1.0,
    return_state: bool = False,
):
    """UGRNN recurrence with zero h0 given the input projection; [B, T, U],
    and with ``return_state`` also the f32 states (the training residual)."""
    global launches
    _check(x_proj, w_hh, mask)
    if x_proj.device.type == "cpu":
        return ugrnn_scan_reference(x_proj, w_hh, mask, forget_bias, return_state)
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
    hs = (torch.empty((b, t, units), dtype=torch.float32, device=x_proj.device)
          if return_state else None)
    if b == 0 or t == 0:
        return (out, hs) if return_state else out
    fn = _library()
    with torch.cuda.device(x_proj.device):
        err = fn(
            x_proj.data_ptr(), w_hh.data_ptr(), mask.data_ptr(),
            out.data_ptr(), hs.data_ptr() if return_state else None, b, t, units,
            _DTYPE_CODES[x_proj.dtype], float(forget_bias),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ugrnn_fwd launch failed: cudaError {err}")
    launches += 1
    return (out, hs) if return_state else out


def ugrnn_scan_bwd_kernel(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    mask: torch.Tensor,
    hs: torch.Tensor,
    g_out: torch.Tensor,
    forget_bias: float = 1.0,
):
    """(dx_proj, dW_hh) of the recurrence from the forward's f32 states
    ``hs`` and the output cotangent ``g_out`` [B, T, U]."""
    global bwd_launches
    _check(x_proj, w_hh, mask)
    b, t, two_u = x_proj.shape
    units = two_u // 2
    for name, tensor in (("hs", hs), ("g_out", g_out)):
        if tuple(tensor.shape) != (b, t, units) or tensor.device != x_proj.device:
            raise ValueError(f"{name} must be [{b}, {t}, {units}] on {x_proj.device}")
    if hs.dtype != torch.float32:
        raise TypeError("hs must be float32")
    if x_proj.device.type == "cpu":
        return ugrnn_scan_bwd_reference(x_proj, w_hh, mask, hs, g_out, forget_bias)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    g_out = g_out.to(x_proj.dtype).contiguous()
    for name, tensor in (("x_proj", x_proj), ("w_hh", w_hh), ("mask", mask),
                         ("hs", hs)):
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if units > _MAX_UNITS:
        raise ValueError(f"the kernel takes at most {_MAX_UNITS} units")
    da = torch.empty((b, t, two_u), dtype=torch.float32, device=x_proj.device)
    dx = da if x_proj.dtype == torch.float32 else torch.empty_like(x_proj)
    dw = torch.empty_like(w_hh)
    if b == 0 or t == 0:
        return dx.zero_(), dw.zero_()
    w_t = w_hh.t().contiguous()  # [2U, U]: coalesced loads for the carry
    fn = _bwd_library()
    with torch.cuda.device(x_proj.device):
        err = fn(
            x_proj.data_ptr(), w_hh.data_ptr(), w_t.data_ptr(), mask.data_ptr(),
            hs.data_ptr(), g_out.data_ptr(), da.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), b, t, units, _DTYPE_CODES[x_proj.dtype],
            float(forget_bias), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ugrnn_bwd launch failed: cudaError {err}")
    bwd_launches += 1
    return dx, dw


class UGRNNScan(torch.autograd.Function):
    """The UGRNN recurrence with the Pallas kernel's custom VJP: the forward
    kernel also keeps the f32 states, the backward kernel recomputes the
    gates from them (the twins on the CPU).  The mask and forget bias get no
    gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, mask, forget_bias):
        out, hs = ugrnn_scan_kernel(x_proj, w_hh, mask, forget_bias,
                                    return_state=True)
        ctx.save_for_backward(x_proj, w_hh, mask, hs)
        ctx.forget_bias = forget_bias
        return out

    @staticmethod
    def backward(ctx, g_out):
        x_proj, w_hh, mask, hs = ctx.saved_tensors
        dx, dw = ugrnn_scan_bwd_kernel(x_proj, w_hh, mask, hs, g_out,
                                       ctx.forget_bias)
        return dx, dw, None, None
