"""Fused candidate scorer: the hand-written CUDA kernels and their twins.

``cand_score_kernel`` replaces the TPU forward kernels of
``chameleon_recsys_tpu/ops/pallas/cand_scorer.py``: ``_fwd_kernel`` (eval,
``stash_nc=False``) and, with ``return_nc=True``, ``_fwd_stash_kernel``
(training), which also returns the CAR output ``nc``.  Both launch
``csrc/cand_score_fwd.cu``.  ``cand_score_bwd_kernel`` replaces the backward
``_bwd_kernel_stash`` (``_bwd_vjp``) and ``cand_score_bwd_recompute_kernel``
the backward ``_bwd_kernel``, which recomputes nc instead of reading the
stash; both launch ``csrc/cand_score_bwd.cu``.  On a CUDA tensor a wrapper
launches its kernel or raises; on a CPU tensor it runs its plain PyTorch twin
(``cand_score_reference``, ``cand_score_bwd_reference``).  ``cand_score`` is
the differentiable entry: with ``_STASH_NC`` on (the default, read at call
time as the JAX module reads it), ``CandScore`` stashes ``nc`` in the
forward and runs the stash backward; with it off the forward is the eval
forward and the backward recomputes nc, which saves the [N, C] stash between
the two.  With grad off ``cand_score`` calls the eval forward.

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
_BWD_SOURCE = "cand_score_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M1 = 128  # the first matching layer's accumulators live in registers

# The training forward stashes nc for the backward (True), or the backward
# recomputes it (False), as ``_STASH_NC`` of the JAX module.
_STASH_NC = True

# Launches of the CUDA kernels in this process; the CPU path does not count.
launches = 0  # the eval forward (no stash)
stash_launches = 0  # the training forward, which also writes nc
bwd_launches = 0  # the stash backward (one per call, whatever grids it runs)
bwd_recompute_launches = 0  # the backward that recomputes nc


def _dleaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x > 0, 1.0, alpha)


def _leaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * x)


def cand_score_reference(
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4, alpha=0.2,
    return_nc=False,
):
    """Plain PyTorch twin of the kernel: products in f32 on the rounded
    operands, each activation rounded to the input dtype; [BT, K] f32, and
    with ``return_nc`` also the rounded CAR output nc [BT*K, C]."""
    bt, c = u.shape
    k = i_rows.shape[0] // bt
    d = i_rows.dtype
    pre = _leaky(i_rows.reshape(bt, k, c).float() + u.float()[:, None, :], alpha)
    pre = pre.to(d)
    nc = torch.tanh(pre.float() @ car_w.float() + car_b.float()).to(d)
    x = nc * pred[:, None, :]  # rounded to d, as bf16 * bf16 is
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        x = _leaky(x.float() @ w.float() + b.float(), alpha).to(d)
    scores = (x.float() * w4.float()).sum(-1)
    if return_nc:
        return scores, nc.reshape(bt * k, c)
    return scores


def cand_score_bwd_reference(
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4, nc, g,
    alpha=0.2,
):
    """Plain PyTorch twin of the backward kernels, line by line the Pallas
    ``_bwd_body``: on the stashed ``nc``, or with ``nc=None`` on nc
    recomputed by ``cand_score_reference`` (the same roundings, so the two
    give the same bits); the cotangent chain rounded to the input dtype
    where Pallas rounds it, tanh' from the rounded nc, every product and sum
    in f32.  ``g`` is the scores' cotangent [BT, K].  Returns the 12
    gradients (di, du, dp, dcar_w, dcar_b, dw1, db1, dw2, db2, dw3, db3,
    dw4), each in its operand's dtype."""
    if nc is None:
        _, nc = cand_score_reference(i_rows, u, pred, car_w, car_b, w1, b1, w2,
                                     b2, w3, b3, w4, alpha=alpha, return_nc=True)
    bt, c = u.shape
    n = i_rows.shape[0]
    k = n // bt
    d = i_rows.dtype

    def rep(x):  # [BT, C] -> [N, C], row r gets x[r // K]
        return x[:, None, :].expand(bt, k, c).reshape(n, c)

    def seg_sum(x):  # [N, C] -> [BT, C] in f32, then the dtype
        return x.float().reshape(bt, k, c).sum(1).to(d)

    a0 = i_rows.float() + rep(u.float())
    pre = _leaky(a0, alpha).to(d)
    p_rep = rep(pred)
    prod = nc * p_rep
    a1 = prod.float() @ w1.float() + b1.float()
    x1 = _leaky(a1, alpha).to(d)
    a2 = x1.float() @ w2.float() + b2.float()
    x2 = _leaky(a2, alpha).to(d)
    a3 = x2.float() @ w3.float() + b3.float()
    x3 = _leaky(a3, alpha).to(d)

    ds = g.reshape(n, 1).float()
    dx3 = ds * w4.float()[None, :]
    dw4 = (x3.float() * ds).sum(0)
    da3 = (dx3 * _dleaky(a3, alpha)).to(d)
    dw3 = x2.float().T @ da3.float()
    db3 = da3.float().sum(0)
    dx2 = da3.float() @ w3.float().T
    da2 = (dx2 * _dleaky(a2, alpha)).to(d)
    dw2 = x1.float().T @ da2.float()
    db2 = da2.float().sum(0)
    dx1 = da2.float() @ w2.float().T
    da1 = (dx1 * _dleaky(a1, alpha)).to(d)
    dw1 = prod.float().T @ da1.float()
    db1 = da1.float().sum(0)
    dprod = (da1.float() @ w1.float().T).to(d)

    dnc = dprod * p_rep
    dp = seg_sum(dprod * nc)
    dncp_c = (dnc * (1 - nc * nc)).to(d)
    dcar_w = pre.float().T @ dncp_c.float()
    dcar_b = dncp_c.float().sum(0)
    dpre = dncp_c.float() @ car_w.float().T
    da0 = (dpre * _dleaky(a0, alpha)).to(d)
    return (
        da0, seg_sum(da0), dp,
        dcar_w.to(car_w.dtype), dcar_b.to(car_b.dtype),
        dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype),
        dw3.to(w3.dtype), db3.to(b3.dtype), dw4.to(w4.dtype),
    )


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
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_longlong] + [
            ctypes.c_int
        ] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_library():
    lib = build.load(_BWD_SOURCE)
    fn, size = lib.cand_score_bwd, lib.cand_score_bwd_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 27 + [ctypes.c_longlong] + [
            ctypes.c_int
        ] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6
        size.restype = ctypes.c_longlong
    return fn, size


def _check_launchable(tensors, w1):
    for tensor in tensors:
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError("the operands must be contiguous and 16-byte aligned")
    if w1.shape[1] > _MAX_M1:
        raise ValueError(f"the kernel takes at most {_MAX_M1} first-layer units")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: cudaError {err} (1 is a shape the kernel "
            "cannot take, e.g. C too wide for shared memory)"
        )


def cand_score_kernel(
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4, alpha=0.2,
    return_nc=False,
):
    """Fused candidate scores [BT, K] float32 (the w4 bias left out); with
    ``return_nc`` (the training forward) also the CAR output nc [BT*K, C]
    in the operands' dtype."""
    global launches, stash_launches
    operands = _check(i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4)
    if i_rows.device.type == "cpu":
        return cand_score_reference(*operands, alpha=alpha, return_nc=return_nc)
    if i_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {i_rows.device}")
    _check_launchable(operands, w1)
    bt, c = u.shape
    n_rows = i_rows.shape[0]
    m1, m2, m3 = w1.shape[1], w2.shape[1], w3.shape[1]
    out = torch.empty(n_rows, dtype=torch.float32, device=i_rows.device)
    nc = torch.empty_like(i_rows) if return_nc else None
    if n_rows == 0:
        out = out.reshape(bt, 0)
        return (out, nc) if return_nc else out
    fn = _library()
    with torch.cuda.device(i_rows.device):
        err = fn(
            *(t.data_ptr() for t in operands), out.data_ptr(),
            nc.data_ptr() if return_nc else None,
            n_rows, n_rows // bt, c, m1, m2, m3, _DTYPE_CODES[i_rows.dtype],
            float(alpha), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "cand_score_fwd")
    if return_nc:
        stash_launches += 1
        return out.reshape(bt, n_rows // bt), nc
    launches += 1
    return out.reshape(bt, n_rows // bt)


def _bwd(operands, nc, g, alpha):
    """The backward on a CPU tensor (the twin) or a CUDA tensor (the kernel;
    a null nc launches the recompute variant); (grads, launched)."""
    i_rows, u, w1 = operands[0], operands[1], operands[5]
    bt = u.shape[0]
    if nc is not None and (tuple(nc.shape) != tuple(i_rows.shape)
                           or nc.dtype != i_rows.dtype):
        raise ValueError("nc must be [BT*K, C] in the operands' dtype")
    if g.numel() != i_rows.shape[0] or g.device != i_rows.device:
        raise ValueError("g must hold one cotangent per candidate row")
    g = g.reshape(-1).float().contiguous()
    if i_rows.device.type == "cpu":
        return cand_score_bwd_reference(*operands, nc, g.reshape(bt, -1),
                                        alpha=alpha), False
    if i_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {i_rows.device}")
    _check_launchable(operands + ((g,) if nc is None else (nc, g)), w1)
    n_rows, c = i_rows.shape
    m1, m2, m3 = w1.shape[1], operands[7].shape[1], operands[9].shape[1]
    grads = tuple(torch.empty_like(t) for t in operands)
    fn, size = _bwd_library()
    dtype = _DTYPE_CODES[i_rows.dtype]
    n_bytes = size(n_rows, n_rows // bt, c, m1, m2, m3, dtype)
    if n_bytes < 0:
        raise ValueError(f"cand_score_bwd cannot take the shape {tuple(i_rows.shape)}")
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=i_rows.device)
    with torch.cuda.device(i_rows.device):
        err = fn(
            *(t.data_ptr() for t in operands),
            None if nc is None else nc.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in grads), scratch.data_ptr(),
            n_rows, n_rows // bt, c, m1, m2, m3, dtype, float(alpha),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "cand_score_bwd")
    return grads, True


def cand_score_bwd_kernel(
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4, nc, g,
    alpha=0.2,
):
    """The 12 gradients of the fused scorer (see
    ``cand_score_bwd_reference``) from the stashed ``nc`` and the scores'
    cotangent ``g`` [BT, K]."""
    global bwd_launches
    operands = _check(i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4)
    grads, launched = _bwd(operands, nc, g, alpha)
    bwd_launches += launched
    return grads


def cand_score_bwd_recompute_kernel(
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4, g, alpha=0.2,
):
    """The 12 gradients of the fused scorer from the operands and the
    scores' cotangent ``g`` [BT, K] alone: nc is recomputed, as the forward
    forms it, inside the backward (``_bwd_kernel``)."""
    global bwd_recompute_launches
    operands = _check(i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4)
    grads, launched = _bwd(operands, None, g, alpha)
    bwd_recompute_launches += launched
    return grads


class CandScore(torch.autograd.Function):
    """The fused scorer with the Pallas kernel's custom VJP.  With
    ``_STASH_NC`` on, the forward stashes nc (K1fs) and the backward runs the
    stash backward (K1b) on it; with it off, the forward is the eval forward
    (K1f) and the backward recomputes nc (K1b'); on the CPU the twins.
    ``alpha`` gets no gradient."""

    @staticmethod
    def forward(ctx, i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3,
                w4, alpha):
        operands = (i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4)
        ctx.stash = _STASH_NC
        if ctx.stash:
            scores, nc = cand_score_kernel(*operands, alpha=alpha, return_nc=True)
            ctx.save_for_backward(*operands, nc)
        else:
            scores = cand_score_kernel(*operands, alpha=alpha)
            ctx.save_for_backward(*operands)
        ctx.alpha = alpha
        return scores

    @staticmethod
    def backward(ctx, g):
        if ctx.stash:
            grads = cand_score_bwd_kernel(*ctx.saved_tensors, g, alpha=ctx.alpha)
        else:
            grads = cand_score_bwd_recompute_kernel(*ctx.saved_tensors, g,
                                                    alpha=ctx.alpha)
        return grads + (None,)


def cand_score(i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4,
               alpha=0.2) -> torch.Tensor:
    """Differentiable fused scores [BT, K] f32: through ``CandScore`` when
    autograd records, else the eval forward (no stash)."""
    operands = (i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return CandScore.apply(*operands, alpha)
    return cand_score_kernel(*operands, alpha=alpha)
