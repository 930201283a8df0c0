"""Fused candidate scorer: the hand-written CUDA kernels and their twins.

``cand_score_kernel`` replaces the TPU forward kernels of
``chameleon_recsys_tpu/ops/pallas/cand_scorer.py``: ``_fwd_kernel`` (eval,
``stash_nc=False``) and, with ``return_nc=True``, ``_fwd_stash_kernel``
(training), which also returns the CAR output ``nc``.  Both launch
``csrc/cand_score_fwd.cu``.  ``cand_score_bwd_kernel`` replaces the backward
``_bwd_kernel_stash`` (``_bwd_vjp``) and ``cand_score_bwd_recompute_kernel``
the backward ``_bwd_kernel``, which recomputes nc instead of reading the
stash: it launches the stash forward with its nc written into the ``di``
buffer, then the same ``csrc/cand_score_bwd.cu`` on that nc.  The backward's
C-wide products (dW1, dpre, dcar_w) run on a hand-written wgmma + TMA GEMM
core (``csrc/sm90_gemm.cuh``), in bf16 or in f32 as split TF32;
``sm90_gemm_kernel`` calls the bf16 core alone (for its tests).  In bf16 a C
or a first matching width that is no multiple of 8 is zero-padded around the
backward (``pad_widths`` / ``slice_widths``).  On a CUDA tensor a wrapper
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
tensor cores bound it.  In bf16 the kernel keeps a block's 64 PreCAR rows in
shared memory, streams ``car_W`` and W1 tiles by TMA, runs the CAR product on
wgmma, and folds each 64-column tile of its output straight into the first
matching layer (wgmma with A from registers), then the other two layers, so
the [N, C] intermediates never reach device memory.  The source says more.

The card's kernels take only some widths; ``kernel_takes`` says which, from
the shapes alone, and the model's gate (``models/nar.py``) takes the plain
branch for the others, as the JAX package's gate does for shapes its kernel
cannot take.  In bf16 a C or matching width that is no multiple of 8 is
zero-padded around both kernels (``pad_widths``, ``pad_forward``).

Numerics are the Pallas kernel's (``_fwd_compute``), not those of the JAX
``cand_score_reference``: ``i + u`` is added in f32, and each activation is
rounded to the input dtype once, after its bias and nonlinearity.  float32
inputs run on the tensor cores in split TF32: each product as three TF32
products of the operands' hi and lo halves, f32-like accuracy (the f32
forward's nc within ~6e-7 of the exactly rounded one, closer than cuBLAS's
f32 product at C 1024); its matching tail runs on the CUDA cores.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SOURCE = "cand_score_fwd"
_BWD_SOURCE = "cand_score_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' width limits, from the sources (a card test holds each against
# the libraries' own byte counts): the first matching layer's accumulators
# live in registers (kMaxM1 of both .cu files); the bf16 forward's last two
# layers are m64n128 products at most (kMaxM23), and its shared memory,
# which C alone sizes, fits the 227 KB a block may use up to C 1536
# (kMaxKBlocks); the f32 forward's depends on the matching widths alone
# (``_f32_fwd_smem_bytes``), the backward row kernel's on those too
# (``_bwd_smem_bytes``).
_MAX_M1 = 128
_BF16_MAX_M23 = 128
_BF16_MAX_C = 1536
_SMEM_LIMIT = 232448
_F32_MAIN_SMEM = 1024 + 4 * 16384 + 128 * 64 * 4 + 2 * 4 * 8
# bf16 widths that the TMA maps take: rows of a multiple of 16 bytes
_ALIGN = 8

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


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _f32_fwd_smem_bytes(c: int, m1: int, m2: int, m3: int) -> int:
    """The largest dynamic shared memory of the f32 forward's launches
    (``cand_score_fwd.cu``, namespace ``f32``): the main kernel's ring of four
    16 KB stages, its 32 KB of first-layer sums, the barriers and 1 KB of
    alignment slack (99,392 bytes, whatever the widths: pre is formed in
    registers, not kept), or the matching tail's 16 rows of x1, x2 and x3 in
    f32."""
    return max(_F32_MAIN_SMEM, 4 * 16 * (m1 + m2 + m3))


def _bwd_smem_bytes(m1: int, m2: int, m3: int, dtype) -> int:
    """Dynamic shared memory of ``cand_score_bwd.cu``'s row kernel (its
    ``RowLayout``): a ring of stages (a W1 tile, the nc and pred chunks; in
    the tail W2 and W3), the tail's buffers (or the f32 stage aliasing
    them), da1 and the rows' indices, each 128-byte aligned."""
    e = 2 if dtype == torch.bfloat16 else 4
    rows, pad, stages = (64, 8, 3) if e == 2 else (32, 4, 2)
    m1_pad = _up(m1, 16)
    stage = max(_up(64 * (m1_pad + pad) * e, 128) + 2 * _up(rows * (64 + pad) * e, 128),
                _up(m1 * (m2 + 3 - e // 2) * e, 128) + _up(m2 * (m3 + 3 - e // 2) * e, 128))
    buffers = sum(_up(rows * b, 128) for b in (
        (m1_pad + 4) * 4, (m1_pad + pad) * e, m2 * 4, m2 * e, m2 * e, m3 * 4, m3 * e,
        m3 * e))
    return (stages * stage + max(buffers, _up(rows * 68 * 4, 128))
            + _up(rows * (m1_pad + pad) * e, 128) + _up(rows * 4, 128))


def kernel_limit(c: int, m1: int, m2: int, m3: int, dtype, train: bool = False):
    """The first limit of the card's fused-scorer kernels that these widths
    break (the forward's, and with ``train`` the backward's too), as a
    sentence, or None where the kernels take them.  Shapes alone decide it:
    it launches nothing and answers the same on the CPU."""
    if dtype not in _DTYPE_CODES:
        return f"the kernels take float32 or bfloat16, not {dtype}"
    bwd_widths = (m1, m2, m3)
    if dtype == torch.bfloat16:  # widths are zero-padded to 8 for TMA
        c, m1, m2, m3 = (_up(v, _ALIGN) for v in (c, m1, m2, m3))
        bwd_widths = (m1,) + bwd_widths[1:]  # the backward pads C and M1 only
    if m1 > _MAX_M1:
        return f"the first matching layer has {m1} units, more than {_MAX_M1}"
    if dtype == torch.bfloat16:
        if max(m2, m3) > _BF16_MAX_M23:
            return (f"the bf16 forward takes at most {_BF16_MAX_M23} units in the second "
                    f"and third matching layers, not {m2} and {m3}")
        if c > _BF16_MAX_C:
            return (f"the bf16 forward takes C up to {_BF16_MAX_C}, not {c} (the block's "
                    f"pre beside its rings in shared memory)")
    elif (fwd := _f32_fwd_smem_bytes(c, m1, m2, m3)) > _SMEM_LIMIT:
        return (f"the f32 forward needs {fwd} bytes of shared memory for its matching "
                f"tail (M1 + M2 + M3 = {m1 + m2 + m3}), more than the {_SMEM_LIMIT} a "
                f"block may use")
    if train and (bwd := _bwd_smem_bytes(*bwd_widths, dtype)) > _SMEM_LIMIT:
        return (f"the backward's row kernel needs {bwd} bytes of shared memory, "
                f"more than the {_SMEM_LIMIT} a block may use")
    return None


def kernel_takes(c: int, m1: int, m2: int, m3: int, dtype, train: bool = False) -> bool:
    """Whether the card's fused-scorer forward (and, with ``train``, its
    backward) takes a CAR width ``c`` and matching widths ``m1, m2, m3`` in
    ``dtype``: a pure shape predicate, the gate of ``models/nar.py``."""
    return kernel_limit(c, m1, m2, m3, dtype, train) is None


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
        ] * 6 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _fwd_scratch(n_rows, c, m1, m2, m3, dtype, device):
    """The forward's scratch (f32: the weights' split halves and the
    first layer's partials), or None where it needs none."""
    size = build.load(_SOURCE).cand_score_fwd_scratch_bytes
    if size.argtypes is None:
        size.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
        size.restype = ctypes.c_longlong
    n_bytes = size(n_rows, c, m1, m2, m3, _DTYPE_CODES[dtype])
    if n_bytes < 0:
        raise ValueError(f"cand_score_fwd cannot take rows {n_rows} at widths "
                         f"{(c, m1, m2, m3)}")
    return torch.empty(n_bytes, dtype=torch.uint8, device=device) if n_bytes else None


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


def _check_launchable(tensors, c, m1, m2, m3, train=False):
    for tensor in tensors:
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError("the operands must be contiguous and 16-byte aligned")
    limit = kernel_limit(c, m1, m2, m3, tensors[0].dtype, train)
    if limit is not None:
        raise ValueError(f"the fused scorer kernels cannot take these widths: {limit}")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _widths(operands):
    """(C, M1, M2, M3) of the operands."""
    return (operands[0].shape[1],) + tuple(operands[i].shape[1] for i in (5, 7, 9))


def _fwd_into(operands, scores, nc, alpha):
    """Launches the forward kernel on the card: the f32 scores into
    ``scores`` [N] and, where ``nc`` is given, the CAR output into it.  In
    bf16 every width that is no multiple of 8 is zero-padded first
    (``pad_forward``); a padded C writes nc into a padded buffer, cut back."""
    i_rows, u = operands[0], operands[1]
    n_rows = i_rows.shape[0]
    c, m1, m2, m3 = _widths(operands)
    out_nc = nc
    if i_rows.dtype == torch.bfloat16 and any(v % _ALIGN for v in (c, m1, m2, m3)):
        operands = pad_forward(operands)
        if nc is not None and c % _ALIGN:
            nc = torch.empty_like(operands[0])
        c, m1, m2, m3 = _widths(operands)
    with torch.cuda.device(i_rows.device):
        scratch = _fwd_scratch(n_rows, c, m1, m2, m3, i_rows.dtype, i_rows.device)
        err = _library()(
            *(t.data_ptr() for t in operands), scores.data_ptr(),
            None if nc is None else nc.data_ptr(),
            n_rows, n_rows // u.shape[0], c, m1, m2, m3,
            _DTYPE_CODES[i_rows.dtype], float(alpha),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "cand_score_fwd")
    if nc is not out_nc:
        out_nc.copy_(nc[:, :out_nc.shape[1]])


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
    _check_launchable(operands, *_widths(operands))
    bt = u.shape[0]
    n_rows = i_rows.shape[0]
    out = torch.empty(n_rows, dtype=torch.float32, device=i_rows.device)
    nc = torch.empty_like(i_rows) if return_nc else None
    if n_rows == 0:
        out = out.reshape(bt, 0)
        return (out, nc) if return_nc else out
    _fwd_into(operands, out, nc, alpha)
    if return_nc:
        stash_launches += 1
        return out.reshape(bt, n_rows // bt), nc
    launches += 1
    return out.reshape(bt, n_rows // bt)


def pad_widths(operands, nc, c_to, m1_to):
    """The operands (and nc) with C zero-padded to ``c_to`` (the columns of
    i_rows, u, pred and nc, the rows and columns of car_w, car_b, the rows
    of w1) and the first matching width to ``m1_to`` (the columns of w1,
    b1, the rows of w2).  In the padded columns pre, nc, prod, a1 and x1 are
    0, so every gradient's real entries are those of the unpadded operands."""
    i_rows, u, pred, car_w, car_b, w1, b1, w2 = operands[:8]
    extra, m1_extra = c_to - i_rows.shape[1], m1_to - w1.shape[1]
    pad = torch.nn.functional.pad
    padded = (pad(i_rows, (0, extra)), pad(u, (0, extra)), pad(pred, (0, extra)),
              pad(car_w, (0, extra, 0, extra)), pad(car_b, (0, extra)),
              pad(w1, (0, m1_extra, 0, extra)), pad(b1, (0, m1_extra)),
              pad(w2, (0, 0, 0, m1_extra))) + tuple(operands[8:])
    return padded, None if nc is None else pad(nc, (0, extra))


def pad_forward(operands):
    """bf16 operands with C and every matching width zero-padded to a
    multiple of 8, as the forward's TMA maps need: C and M1 by
    ``pad_widths``, then the columns of w2, b2 (M2) and the rows of w3, the
    columns of w3, b3 and w4 (M3).  Every padded activation is 0, so the
    scores are the unpadded ones and nc's first C columns the unpadded nc."""
    c, m1, m2, m3 = _widths(operands)
    padded, _ = pad_widths(operands, None, _up(c, _ALIGN), _up(m1, _ALIGN))
    w2, b2, w3, b3, w4 = padded[7:]
    e2, e3 = _up(m2, _ALIGN) - m2, _up(m3, _ALIGN) - m3
    pad = torch.nn.functional.pad
    return padded[:7] + (pad(w2, (0, e2)), pad(b2, (0, e2)), pad(w3, (0, e3, 0, e2)),
                         pad(b3, (0, e3)), pad(w4, (0, e3)))


def slice_widths(grads, c, m1):
    """The 12 gradients of ``pad_widths``'s operands cut back to C = ``c``
    and the first matching width ``m1``."""
    di, du, dp, dcar_w, dcar_b, dw1, db1, dw2 = grads[:8]
    return (di[:, :c].contiguous(), du[:, :c].contiguous(), dp[:, :c].contiguous(),
            dcar_w[:c, :c].contiguous(), dcar_b[:c].contiguous(),
            dw1[:c, :m1].contiguous(), db1[:m1].contiguous(),
            dw2[:m1].contiguous()) + tuple(grads[8:])


def _bwd(operands, nc, g, alpha):
    """The backward on a CPU tensor (the twin) or a CUDA tensor (the kernel;
    nc None runs the recompute variant: the stash forward writes nc into
    the di buffer, then the backward reads it there); (grads, launched)."""
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
    _check_launchable(operands + ((g,) if nc is None else (nc, g)), *_widths(operands),
                      train=True)
    c, m1 = i_rows.shape[1], w1.shape[1]
    if i_rows.dtype == torch.bfloat16 and (c % _ALIGN or m1 % _ALIGN):
        operands, nc = pad_widths(operands, nc, _up(c, _ALIGN), _up(m1, _ALIGN))
        return slice_widths(_bwd_launch(operands, nc, g, alpha), c, m1), True
    return _bwd_launch(operands, nc, g, alpha), True


def _bwd_launch(operands, nc, g, alpha):
    i_rows, u, w1 = operands[0], operands[1], operands[5]
    bt = u.shape[0]
    n_rows, c = i_rows.shape
    m1, m2, m3 = w1.shape[1], operands[7].shape[1], operands[9].shape[1]
    dtype = _DTYPE_CODES[i_rows.dtype]
    grads = tuple(torch.empty_like(t) for t in operands)
    fn, size = _bwd_library()
    n_bytes = size(n_rows, n_rows // bt, c, m1, m2, m3, dtype)
    if n_bytes < 0:
        raise ValueError(f"cand_score_bwd cannot take the shape {tuple(i_rows.shape)}")
    scratch = torch.empty(n_bytes, dtype=torch.uint8, device=i_rows.device)
    with torch.cuda.device(i_rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        if nc is None:  # K1b': nc from the stash forward's own launch, into di
            nc = grads[0]
            scores = torch.empty(n_rows, dtype=torch.float32, device=i_rows.device)
            _fwd_into(operands, scores, nc, alpha)
        err = fn(
            *(t.data_ptr() for t in operands), nc.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in grads), scratch.data_ptr(),
            n_rows, n_rows // bt, c, m1, m2, m3, dtype, float(alpha), stream,
        )
    _raise_on(err, "cand_score_bwd")
    return grads


def sm90_gemm_kernel(a, b, trans_a=False, trans_b=False):
    """The backward's GEMM core alone, for its tests: bf16 ``A op B`` on the
    card with f32 accumulation, A [M, K] (or [K, M] read transposed with
    ``trans_a``) and B [N, K] read as B^T (or [K, N] with ``trans_b``); the
    stored row lengths a multiple of 8.  Returns C [M, N] bf16."""
    for t in (a, b):
        if (t.dtype != torch.bfloat16 or t.device.type != "cuda" or t.dim() != 2
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("the GEMM core takes contiguous, 16-byte aligned 2-D "
                             "bfloat16 tensors on the card")
    m, k = a.shape[::-1] if trans_a else a.shape
    n, k_b = b.shape[::-1] if trans_b else b.shape
    if k != k_b or a.shape[1] % 8 or b.shape[1] % 8 or n % 8:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do not fit")
    out = torch.empty(m, n, dtype=torch.bfloat16, device=a.device)
    lib = build.load(_BWD_SOURCE)
    fn = lib.sm90_gemm_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(trans_a),
                 int(trans_b), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "sm90_gemm")
    return out


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
    scores' cotangent ``g`` [BT, K] alone (``_bwd_kernel``): on the card nc
    is formed by the stash forward's own launch into the ``di`` buffer, then
    the stash backward runs on it, so the gradients are
    ``cand_score_bwd_kernel``'s on the forward's nc, bit for bit."""
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
