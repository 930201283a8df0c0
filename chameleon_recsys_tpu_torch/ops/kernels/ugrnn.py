"""UGRNN scan: the hand-written CUDA kernels and their plain twins.

``ugrnn_scan_kernel`` replaces the TPU kernel
``chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py::_fwd_kernel`` and
launches ``csrc/ugrnn_fwd.cu``; ``ugrnn_scan_bwd_kernel`` replaces its
backward ``_bwd_kernel`` (``_bwd_vjp``) and launches ``csrc/ugrnn_bwd.cu``.
On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs its plain twin (``ugrnn_scan_reference``, ``ugrnn_scan_bwd_reference``).
``UGRNNScan`` joins them as an ``autograd.Function``: in training the forward
also keeps the f32 states and the f32 pre-activations (the stash), and the
backward takes the gates from the stash, so the one W-sized product left in
its serial chain is the carry.

What bounds it on an H100: the recurrence is a chain of T dependent steps (19
at G1), each a small [rows, U] x [U, 2U] product plus gate math, so the time
is the latency of the chain.  Each kernel comes in two instantiations, chosen
by the pure width predicate ``resident_takes`` (the same answer on the CPU):

- *resident*: a thread-block cluster of n CTAs owns a tile of batch rows for
  the whole sequence; CTA q keeps W_hh's entries for its slice of the hidden
  units in shared memory for all T steps (the forward the units' columns, the
  backward their rows) and each step exchanges its slice of h (or da) with
  the other CTAs over distributed shared memory, one cluster barrier a step.
  A width is resident where some cluster of at most 8 CTAs fits a block's
  shared memory (at the G1 width U = 255 from 2 CTAs in bf16 and 3 in f32);
  ``_resident_layout`` mirrors the sources' ``ugrnn_common.cuh`` arithmetic.
  The library picks the cluster size and the rows a cluster owns for each
  batch (``launch_layout``).
- *streaming* (every wider U up to 1024): one block per two batch rows, one
  thread per unit, W_hh read from L2 every step.

Numerics follow the Pallas kernel, not ``ops.rnn.ugrnn_scan``: inputs are
widened to f32, h and the gates stay f32 for the whole sequence, and the
output is rounded once to x_proj's dtype.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build

_SOURCE = "ugrnn_fwd"
_BWD_SOURCE = "ugrnn_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_UNITS = 1024  # the streaming kernels: one thread per hidden unit
# the resident layout's limits (csrc/ugrnn_common.cuh)
_SMEM_LIMIT = 232448
_MAX_CLUSTER = 8
_MAX_THREADS = 512

# Launches of the CUDA kernels in this process; the CPU path does not count.
launches = 0  # the forward, both instantiations
bwd_launches = 0  # the backward (one per call: the chain, dW_hh, its sum)
resident_launches = 0  # the forward's resident instantiation
stream_launches = 0  # the forward's streaming instantiation
bwd_resident_launches = 0
bwd_stream_launches = 0


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Layout:
    n: int  # CTAs in a cluster
    uq: int  # units a CTA owns
    ksplit: int  # depth chunks, one thread group each
    smem: int  # dynamic shared memory bytes


def _layout_at(units: int, elem: int, bwd: bool, n: int, rows: int) -> Layout:
    uq = _ceil_div(units, n)
    ws = uq | 1
    ksplit = min(8, max(1, _MAX_THREADS // uq))
    kc = _ceil_div(_ceil_div(units, ksplit), 4) * 4
    kpad = kc * ksplit
    w_bytes = kpad * ws * 2 * elem
    vec_bytes = (4 if bwd else 2) * rows * kpad * 4
    red_bytes = ksplit * rows * uq * (1 if bwd else 2) * 4 if ksplit > 1 else 0
    return Layout(n, uq, ksplit, w_bytes + vec_bytes + red_bytes)


@functools.lru_cache(maxsize=None)
def _resident_layout(units: int, dtype: torch.dtype, bwd: bool, rows: int = 1):
    """The resident layout of the forward (or, with ``bwd``, the backward's
    chain) at ``rows`` batch rows a cluster, or None where no cluster of at
    most 8 CTAs fits it; n is chosen at one row."""
    if dtype not in _DTYPE_CODES or units <= 0:
        return None
    elem = 2 if dtype == torch.bfloat16 else 4
    for n in range(1, _MAX_CLUSTER + 1):
        if n > 1 and (n - 1) * _ceil_div(units, n) >= units:
            continue  # a CTA would own no unit
        first = _layout_at(units, elem, bwd, n, 1)
        if first.smem > _SMEM_LIMIT or first.ksplit * first.uq > _MAX_THREADS:
            continue
        layout = _layout_at(units, elem, bwd, n, rows)
        return layout if layout.smem <= _SMEM_LIMIT else None
    return None


def resident_takes(units: int, dtype: torch.dtype, train: bool = False) -> bool:
    """Whether the wrappers launch the resident kernels at this width: the
    forward's layout fits a cluster of at most 8 CTAs, and with ``train``
    the backward's too.  ``train`` is the training pair, the forward that
    keeps the stash (``return_acts``) and the backward, which both ask with
    it: they run on one instantiation, so a width whose backward does not fit
    (bf16 649-656 units) streams in training and stays resident in
    inference.  Elsewhere (up to 1024 units) the streaming kernels run.  A
    pure function of the widths: it answers the same on the CPU."""
    if _resident_layout(units, dtype, bwd=False) is None:
        return False
    return not train or _resident_layout(units, dtype, bwd=True) is not None


def ugrnn_scan_reference(
    x_proj: torch.Tensor,  # [B, T, 2U]
    w_hh: torch.Tensor,  # [U, 2U]
    mask: torch.Tensor,  # [B, T] bool
    forget_bias: float = 1.0,
    return_state: bool = False,
    return_acts: bool = False,
):
    """Plain PyTorch twin of the kernel: an f32 time loop, zero h0, output
    in x_proj's dtype; with ``return_state`` also the f32 states, with
    ``return_acts`` the states and the f32 pre-activations
    ``x_proj + h_prev . W_hh`` [B, T, 2U] (the backward's stash)."""
    b, t, two_u = x_proj.shape
    units = two_u // 2
    x = x_proj.float()
    w = w_hh.float()
    h = torch.zeros((b, units), dtype=torch.float32, device=x_proj.device)
    outs, acts_all = [], []
    for step in range(t):
        acts = x[:, step] + h @ w
        acts_all.append(acts)
        g = torch.sigmoid(acts[:, :units] + forget_bias)
        c = torch.tanh(acts[:, units:])
        h_new = g * h + (1.0 - g) * c
        h = torch.where(mask[:, step, None], h_new, h)
        outs.append(h)
    if outs:
        hs = torch.stack(outs, dim=1)
        acts = torch.stack(acts_all, dim=1)
    else:
        hs = torch.zeros((b, 0, units), dtype=torch.float32, device=x.device)
        acts = torch.zeros((b, 0, two_u), dtype=torch.float32, device=x.device)
    out = hs.to(x_proj.dtype)
    if return_acts:
        return out, hs, acts
    return (out, hs) if return_state else out


def ugrnn_scan_bwd_reference(
    x_proj,  # [B, T, 2U], or None with ``acts``
    w_hh: torch.Tensor,  # [U, 2U]
    mask: torch.Tensor,  # [B, T] bool
    hs: torch.Tensor,  # [B, T, U] f32, the forward's states
    g_out: torch.Tensor,  # [B, T, U] cotangent of the output
    forget_bias: float = 1.0,
    acts=None,  # [B, T, 2U] f32, the forward's pre-activations
):
    """Plain PyTorch twin of the backward kernel, the Pallas ``_bwd_kernel``
    step by step: f32 throughout, a masked step flowing through the gate and
    a padded one copying dh.  The gates come from the stash ``acts`` where it
    is given, else they are recomputed from ``hs`` and ``x_proj`` as the
    Pallas kernel does.  Returns (dx_proj in x_proj's dtype, dW_hh in
    W_hh's)."""
    b, t, units = hs.shape
    two_u = 2 * units
    w, g = w_hh.float(), g_out.float()
    device = hs.device
    dh = torch.zeros((b, units), dtype=torch.float32, device=device)
    dx = torch.zeros((b, t, two_u), dtype=torch.float32, device=device)
    dw = torch.zeros((units, two_u), dtype=torch.float32, device=device)
    for step in reversed(range(t)):
        h_prev = hs[:, step - 1].float() if step > 0 else torch.zeros_like(dh)
        if acts is not None:
            a = acts[:, step].float()
        else:
            a = x_proj[:, step].float() + h_prev @ w
        gate = torch.sigmoid(a[:, :units] + forget_bias)
        c = torch.tanh(a[:, units:])
        dh = dh + g[:, step]
        m = mask[:, step, None].to(torch.float32)
        dh_m = dh * m
        da = torch.cat([dh_m * (h_prev - c) * gate * (1.0 - gate),
                        dh_m * (1.0 - gate) * (1.0 - c * c)], dim=-1)
        dx[:, step] = da
        dw += h_prev.T @ da
        dh = dh_m * gate + da @ w.T + dh * (1.0 - m)
    x_dtype = x_proj.dtype if x_proj is not None else w_hh.dtype
    return dx.to(x_dtype), dw.to(w_hh.dtype)


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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _bwd_library():
    lib = build.load(_BWD_SOURCE)
    fn, splits = lib.ugrnn_bwd, lib.ugrnn_bwd_dw_splits
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        splits.argtypes = [ctypes.c_int] * 3
        splits.restype = ctypes.c_int
    return fn, splits


def _require_contiguous(**tensors):
    for name, tensor in tensors.items():
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ugrnn_scan_kernel(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    mask: torch.Tensor,
    forget_bias: float = 1.0,
    return_state: bool = False,
    return_acts: bool = False,
):
    """UGRNN recurrence with zero h0 given the input projection; [B, T, U].
    With ``return_state`` also the f32 states; with ``return_acts`` the
    states and the f32 pre-activations [B, T, 2U] (the training residuals
    ``ugrnn_scan_bwd_kernel`` takes)."""
    global launches, resident_launches, stream_launches
    _check(x_proj, w_hh, mask)
    if x_proj.device.type == "cpu":
        return ugrnn_scan_reference(x_proj, w_hh, mask, forget_bias, return_state,
                                    return_acts)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    _require_contiguous(x_proj=x_proj, w_hh=w_hh, mask=mask)
    b, t, two_u = x_proj.shape
    units = two_u // 2
    if units > _MAX_UNITS:
        raise ValueError(f"the kernel takes at most {_MAX_UNITS} units")
    device = x_proj.device
    out = torch.empty((b, t, units), dtype=x_proj.dtype, device=device)
    hs = (torch.empty((b, t, units), dtype=torch.float32, device=device)
          if return_state or return_acts else None)
    acts = (torch.empty((b, t, two_u), dtype=torch.float32, device=device)
            if return_acts else None)
    if b and t:
        resident = resident_takes(units, x_proj.dtype, train=return_acts)
        fn = _library()
        with torch.cuda.device(device):
            err = fn(
                x_proj.data_ptr(), w_hh.data_ptr(), mask.data_ptr(),
                out.data_ptr(), None if hs is None else hs.data_ptr(),
                None if acts is None else acts.data_ptr(), b, t, units,
                _DTYPE_CODES[x_proj.dtype], float(forget_bias), int(resident),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"ugrnn_fwd launch failed: cudaError {err}")
        launches += 1
        if resident:
            resident_launches += 1
        else:
            stream_launches += 1
    if return_acts:
        return out, hs, acts
    return (out, hs) if return_state else out


def ugrnn_scan_bwd_kernel(
    x_proj,
    w_hh: torch.Tensor,
    mask: torch.Tensor,
    hs: torch.Tensor,
    g_out: torch.Tensor,
    forget_bias: float = 1.0,
    acts=None,
):
    """(dx_proj, dW_hh) of the recurrence from the forward's f32 states
    ``hs`` and pre-activations ``acts`` (``ugrnn_scan_kernel(...,
    return_acts=True)``) and the output cotangent ``g_out`` [B, T, U].  The
    card's kernel reads the gates from ``acts``; the CPU twin recomputes them
    from ``x_proj`` where ``acts`` is None.  ``x_proj`` may be None where
    ``acts`` is given (dx_proj then takes W_hh's dtype, which x_proj shares)."""
    global bwd_launches, bwd_resident_launches, bwd_stream_launches
    if x_proj is None and acts is None:
        raise ValueError("the backward needs x_proj or the forward's acts")
    if hs.dim() != 3:
        raise ValueError(f"hs must be [B, T, U], got {tuple(hs.shape)}")
    b, t, units = hs.shape
    two_u = 2 * units
    if x_proj is not None:
        _check(x_proj, w_hh, mask)
        if tuple(x_proj.shape) != (b, t, two_u):
            raise ValueError(f"x_proj must be [{b}, {t}, {two_u}]")
    else:
        if tuple(w_hh.shape) != (units, two_u):
            raise ValueError(f"w_hh must be [{units}, {two_u}], got {tuple(w_hh.shape)}")
        if tuple(mask.shape) != (b, t) or mask.dtype != torch.bool:
            raise ValueError(f"mask must be bool [{b}, {t}]")
        if w_hh.dtype not in _DTYPE_CODES:
            raise TypeError("w_hh must be float32 or bfloat16")
        if mask.device != w_hh.device:
            raise ValueError("w_hh and mask must be on one device")
    device = w_hh.device
    named = {"hs": (hs, units), "g_out": (g_out, units)}
    if acts is not None:
        named["acts"] = (acts, two_u)
    for name, (tensor, width) in named.items():
        if tuple(tensor.shape) != (b, t, width) or tensor.device != device:
            raise ValueError(f"{name} must be [{b}, {t}, {width}] on {device}")
    if hs.dtype != torch.float32 or (acts is not None and acts.dtype != torch.float32):
        raise TypeError("hs and acts must be float32")
    if device.type == "cpu":
        return ugrnn_scan_bwd_reference(x_proj, w_hh, mask, hs, g_out, forget_bias,
                                        acts=acts)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if acts is None:
        raise ValueError("the card's backward reads the gates from the forward's "
                         "stash: pass acts (ugrnn_scan_kernel(..., return_acts=True))")
    dtype = w_hh.dtype
    g_out = g_out.to(dtype).contiguous()
    _require_contiguous(w_hh=w_hh, mask=mask, hs=hs, acts=acts)
    if units > _MAX_UNITS:
        raise ValueError(f"the kernel takes at most {_MAX_UNITS} units")
    da = torch.empty((b, t, two_u), dtype=torch.float32, device=device)
    dx = da if dtype == torch.float32 else torch.empty((b, t, two_u), dtype=dtype,
                                                       device=device)
    dw = torch.empty_like(w_hh)
    if b == 0 or t == 0:
        return dx.zero_(), dw.zero_()
    resident = resident_takes(units, dtype, train=True)
    # the streaming chain reads W_hh^T [2U, U]: coalesced loads for the carry
    w_t = None if resident else w_hh.t().contiguous()
    fn, splits = _bwd_library()
    part = torch.empty((splits(b, t, units), units, two_u), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        err = fn(
            w_hh.data_ptr(), None if w_t is None else w_t.data_ptr(),
            mask.data_ptr(), hs.data_ptr(), g_out.data_ptr(), acts.data_ptr(),
            da.data_ptr(), dx.data_ptr(), dw.data_ptr(), part.data_ptr(), b, t,
            units, _DTYPE_CODES[dtype], float(forget_bias), int(resident),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ugrnn_bwd launch failed: cudaError {err}")
    bwd_launches += 1
    if resident:
        bwd_resident_launches += 1
    else:
        bwd_stream_launches += 1
    return dx, dw


class UGRNNScan(torch.autograd.Function):
    """The UGRNN recurrence with the Pallas kernel's custom VJP: the forward
    kernel also keeps the f32 states and pre-activations, which the backward
    kernel reads in place of x_proj (the twins on the CPU).  The mask and
    forget bias get no gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, mask, forget_bias):
        out, hs, acts = ugrnn_scan_kernel(x_proj, w_hh, mask, forget_bias,
                                          return_acts=True)
        ctx.save_for_backward(w_hh, mask, hs, acts)
        ctx.forget_bias = forget_bias
        return out

    @staticmethod
    def backward(ctx, g_out):
        w_hh, mask, hs, acts = ctx.saved_tensors
        dx, dw = ugrnn_scan_bwd_kernel(None, w_hh, mask, hs, g_out, ctx.forget_bias,
                                       acts=acts)
        return dx, dw, None, None
