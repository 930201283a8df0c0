"""The port's CUDA kernels against their plain twins, on the card.

These tests need an NVIDIA card (a hand-written CUDA kernel has no CPU mode)
and skip without one.  They import nothing of JAX, so they also run where
JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 at atol 1e-5 (the same f32 arithmetic, summed in another
order); a bfloat16 UGRNN output at atol 8e-3, two bf16 steps below 1.0
(|h| < 1), since one rounding of the same f32 value may land on either side;
bfloat16 candidate scores at 2e-2, the bf16 tolerance of the JAX package's
own scorer test.  The eval step on the card is held against the same step on
the CPU (f32, the same injected uniforms): probabilities at rtol 1e-4 /
atol 1e-6, ranked ids where the scores are separated, everything else exactly.

The backward kernels are held against their twins output by output, at a
tolerance tied to the largest magnitude of that output: float32 at 2e-4
(sums over thousands of rows in another order), bfloat16 at 2e-2 (a value
next to a rounding boundary of the cotangent chain may round the other way
and carry into the sums).  The scorer's backward is held normwise
(||out - ref|| <= tol ||ref||) with at most 1e-4 of the elements outside
tol * max|ref|: leaky_relu's derivative jumps at 0, and among millions of
pre-activations a few lie within f32 summation noise of 0, so the kernel and
the twin take different slopes there and that row's cotangents differ
outright.  The stashed ``nc`` and the f32 UGRNN states are
the forward's own values: float32 within 1e-5, bfloat16 within one rounding.
The backward's GEMM core alone is held against torch.matmul at one bf16
rounding of the output, and two backward launches must give the same bits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch.data.collate import collate_sessions
from chameleon_recsys_tpu_torch.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer, ugrnn
from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
from chameleon_recsys_tpu_torch.state.stream_state import (
    init_stream_state,
    update_stream_state,
)
from chameleon_recsys_tpu_torch.train.steps import (
    _batch_all_clicks,
    eval_step,
    init_train_state,
    train_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(b, t, units, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, 2 * units, generator=g) * 0.5
    w = torch.randn(units, 2 * units, generator=g) * 0.3 / units ** 0.5
    lengths = torch.randint(0, t + 1, (b,), generator=g)
    mask = torch.arange(t)[None, :] < lengths[:, None]
    return x.to(dtype), w.to(dtype), mask


def _instantiation_counts():
    return (ugrnn.resident_launches, ugrnn.stream_launches,
            ugrnn.bwd_resident_launches, ugrnn.bwd_stream_launches)


# the G1 width at serving, eval and train batches, odd widths, the widest the
# streaming kernels take, and each side of the resident layout's edge in
# each dtype (forward: bf16 656, f32 456; backward: bf16 648, f32 456)
# (8, 7, 24) and (2, 3, 40): CTAs of fewer than 32 threads (a cluster of 8
# at 3 or 5 units a CTA) whose W_hh rows span more words than the block has
# threads
_FWD_SHAPES = [(1, 19, 255), (32, 19, 255), (256, 19, 255), (5, 7, 9), (8, 7, 24),
               (2, 3, 40), (3, 4, 1024), (3, 5, 456), (3, 5, 457), (3, 5, 656),
               (3, 5, 657)]
_BWD_SHAPES = [(1, 19, 255), (32, 19, 255), (256, 19, 255), (5, 7, 9), (8, 7, 24),
               (2, 3, 40), (3, 4, 1024), (3, 5, 456), (3, 5, 457), (3, 5, 648),
               (3, 5, 649)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,units", _FWD_SHAPES)
def test_ugrnn_kernel_matches_reference(card, dtype, b, t, units):
    x, w, mask = (v.to(card) for v in _inputs(b, t, units, dtype))
    before = ugrnn.launches
    counts = _instantiation_counts()
    out = ugrnn.ugrnn_scan_kernel(x, w, mask)
    torch.cuda.synchronize()
    assert ugrnn.launches == before + 1
    resident = ugrnn.resident_takes(units, dtype)
    assert _instantiation_counts()[:2] == (counts[0] + resident, counts[1] + (not resident))
    assert out.dtype == dtype and out.shape == (b, t, units)
    ref = ugrnn.ugrnn_scan_reference(x, w, mask)
    atol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


def test_ugrnn_kernel_rejects_what_it_cannot_take(card):
    x, w, mask = (v.to(card) for v in _inputs(2, 3, 8, torch.float32))
    with pytest.raises(ValueError):
        ugrnn.ugrnn_scan_kernel(x.transpose(0, 1).contiguous().transpose(0, 1), w, mask)
    with pytest.raises(ValueError):
        ugrnn.ugrnn_scan_kernel(*(v.to(card) for v in _inputs(1, 2, 1025, torch.float32)))
    with pytest.raises(TypeError):
        ugrnn.ugrnn_scan_kernel(x, w.to(torch.bfloat16), mask)
    # the card's backward reads the forward's stash; without it, it refuses
    _, hs = ugrnn.ugrnn_scan_kernel(x, w, mask, return_state=True)
    with pytest.raises(ValueError):
        ugrnn.ugrnn_scan_bwd_kernel(x, w, mask, hs, torch.zeros_like(hs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,units", [(256, 19, 255), (5, 7, 9), (3, 4, 1024),
                                       (3, 5, 456), (3, 5, 457)])
def test_ugrnn_stash_is_the_recompute(card, dtype, b, t, units):
    """The forward's f32 pre-activations are x_proj + h_prev . W_hh on its
    own f32 states (summed in another order: within the states' 1e-5), on
    both instantiations; the output and states are the same as without the
    stash, bit for bit."""
    x, w, mask = (v.to(card) for v in _inputs(b, t, units, dtype, seed=5))
    out, hs, acts = ugrnn.ugrnn_scan_kernel(x, w, mask, return_acts=True)
    out2, hs2 = ugrnn.ugrnn_scan_kernel(x, w, mask, return_state=True)
    torch.cuda.synchronize()
    assert acts.dtype == torch.float32 and acts.shape == (b, t, 2 * units)
    assert torch.equal(out, out2) and torch.equal(hs, hs2)
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    recompute = x.float() + (h_prev.reshape(-1, units).double()
                             @ w.double()).float().reshape(b, t, 2 * units)
    torch.testing.assert_close(acts, recompute, rtol=0, atol=1e-5)


def _close_to_scale(out, ref, tol, name):
    """max |out - ref| within ``tol`` times the largest |ref|."""
    scale = max(ref.float().abs().max().item(), 1e-30)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * scale, f"{name}: max error {err:.3e}, largest |ref| {scale:.3e}"


def _close_normwise(out, ref, tol, name, outliers=1e-4):
    """||out - ref|| within ``tol`` ||ref||, and at most a share
    ``outliers`` of the elements off by more than ``tol`` max|ref|."""
    diff = (out.float() - ref.float()).abs()
    scale = max(ref.float().abs().max().item(), 1e-30)
    norm_err = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
    off = int((diff > tol * scale).sum())
    assert norm_err <= tol and off <= outliers * diff.numel(), (
        f"{name}: normwise error {norm_err:.3e}, {off} of {diff.numel()} "
        f"elements beyond {tol} x {scale:.3e} (max error {diff.max().item():.3e})"
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,units", _BWD_SHAPES)
def test_ugrnn_bwd_kernel_matches_reference(card, dtype, b, t, units):
    x, w, mask = (v.to(card) for v in _inputs(b, t, units, dtype, seed=1))
    counts = _instantiation_counts()
    out, hs, acts = ugrnn.ugrnn_scan_kernel(x, w, mask, return_acts=True)
    # the training forward and the backward run on one instantiation
    resident = ugrnn.resident_takes(units, dtype, train=True)
    assert _instantiation_counts()[:2] == (counts[0] + resident, counts[1] + (not resident))
    ref_out, ref_hs = ugrnn.ugrnn_scan_reference(x, w, mask, return_state=True)
    torch.testing.assert_close(hs, ref_hs, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, ref_hs.to(dtype), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 8e-3)
    g = (torch.randn(b, t, units, generator=torch.Generator().manual_seed(2))
         .to(dtype).to(card))
    before = ugrnn.bwd_launches
    counts = _instantiation_counts()
    dx, dw = ugrnn.ugrnn_scan_bwd_kernel(x, w, mask, hs, g, acts=acts)
    torch.cuda.synchronize()
    assert ugrnn.bwd_launches == before + 1
    assert _instantiation_counts()[2:] == (counts[2] + resident, counts[3] + (not resident))
    assert dx.dtype == dtype and dw.dtype == dtype
    # the twin recomputes the gates from the kernel's states
    ref_dx, ref_dw = ugrnn.ugrnn_scan_bwd_reference(x, w, mask, hs, g)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    _close_to_scale(dx, ref_dx, tol, "dx_proj")
    _close_to_scale(dw, ref_dw, tol, "dW_hh")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,units", [(256, 19, 255), (3, 4, 1024)])
def test_ugrnn_bwd_is_deterministic(card, dtype, b, t, units):
    """Two backward launches give the same bits: dW_hh's row splits are
    summed in a fixed order, with no float atomics."""
    x, w, mask = (v.to(card) for v in _inputs(b, t, units, dtype, seed=6))
    _, hs, acts = ugrnn.ugrnn_scan_kernel(x, w, mask, return_acts=True)
    g = (torch.randn(b, t, units, generator=torch.Generator().manual_seed(7))
         .to(dtype).to(card))
    first = ugrnn.ugrnn_scan_bwd_kernel(x, w, mask, hs, g, acts=acts)
    second = ugrnn.ugrnn_scan_bwd_kernel(x, w, mask, hs, g, acts=acts)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ugrnn_resident_limits_mirror_the_source(card, dtype):
    """``resident_takes`` and its layout are the library's own: the resident
    layout's shared-memory bytes and cluster size (``ugrnn_common.cuh``, read
    through ``ugrnn_resident_smem_bytes`` / ``ugrnn_resident_cluster``) at
    every row count, over widths up to 1024."""
    import ctypes
    from chameleon_recsys_tpu_torch.ops.kernels import build

    lib = build.load("ugrnn_fwd")
    smem, cluster = lib.ugrnn_resident_smem_bytes, lib.ugrnn_resident_cluster
    smem.argtypes, smem.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    cluster.argtypes, cluster.restype = [ctypes.c_int] * 3, ctypes.c_int
    code = 1 if dtype == torch.bfloat16 else 0
    for units in list(range(1, 700)) + [800, 1024]:
        for bwd in (False, True):
            for rows in (1, 2, 4, 8):
                layout = ugrnn._resident_layout(units, dtype, bwd, rows)
                n = smem(units, code, int(bwd), rows)
                assert n == (-1 if layout is None else layout.smem), (units, bwd, rows)
            first = ugrnn._resident_layout(units, dtype, bwd)
            assert cluster(units, code, int(bwd)) == (0 if first is None else first.n)
        takes = smem(units, code, 0, 1) >= 0
        assert ugrnn.resident_takes(units, dtype) is takes, units
        assert ugrnn.resident_takes(units, dtype, train=True) is (
            takes and smem(units, code, 1, 1) >= 0), units


def test_ugrnn_scan_function_on_card_matches_cpu(card):
    x, w, mask = _inputs(4, 6, 12, torch.float32, seed=3)
    g = torch.randn(4, 6, 12, generator=torch.Generator().manual_seed(4))
    grads = {}
    for device in ("cpu", card):
        xs, ws = (v.detach().clone().to(device).requires_grad_() for v in (x, w))
        (ugrnn.UGRNNScan.apply(xs, ws, mask.to(device), 1.0) * g.to(device)).sum().backward()
        grads[str(device)] = (xs.grad.cpu(), ws.grad.cpu())
    for got, want in zip(grads[str(card)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def _scorer_inputs(bt, k, c, m1, m2, m3, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dtype)
    return [
        mk(bt * k, c, scale=0.5), mk(bt, c, scale=0.5), mk(bt, c, scale=0.5),
        mk(c, c, scale=c ** -0.5), mk(c, scale=0.1),
        mk(c, m1, scale=(2 / c) ** 0.5), mk(m1, scale=0.1),
        mk(m1, m2, scale=(2 / m1) ** 0.5), mk(m2, scale=0.1),
        mk(m2, m3, scale=(2 / m2) ** 0.5), mk(m3, scale=0.1),
        mk(m3, scale=m3 ** -0.5),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (4864, 50, 1024, 128, 64, 32),  # the G1 eval shape
    (13, 7, 40, 24, 16, 8),  # BT odd, K = 7, C not a multiple of 16
    (5, 3, 37, 9, 5, 3),  # no width a multiple of 8: padded in bf16
    (3, 2, 1280, 128, 7, 1),  # the widest C with two ring stages a warpgroup in bf16
    (3, 2, 1344, 128, 7, 1),  # past it: one ring stage a warpgroup
    (3, 2, 1536, 128, 7, 1),  # the widest C that fits shared memory in bf16
    (61, 3, 1030, 128, 64, 32),  # rows no multiple of 64, C of 17 k-blocks
    (7, 9, 96, 128, 128, 128),  # the bf16 tail's m64n128 products
    (5, 20, 200, 72, 100, 48),  # M2 past 64 and M3 not, padded in bf16
])
def test_cand_score_kernel_matches_reference(card, dtype, shape):
    bt, k = shape[:2]
    operands = [t.to(card) for t in _scorer_inputs(*shape, dtype=dtype)]
    before = cand_scorer.launches
    out = cand_scorer.cand_score_kernel(*operands)
    torch.cuda.synchronize()
    assert cand_scorer.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (bt, k)
    ref = cand_scorer.cand_score_reference(*operands)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


SCORER_GRADS = ("di", "du", "dp", "dcar_w", "dcar_b", "dw1", "db1", "dw2",
                "db2", "dw3", "db3", "dw4")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2688, 50, 1024, 128, 64, 32),  # the compacted G1 train shape
    (13, 7, 40, 24, 16, 8),
    (5, 3, 37, 9, 5, 3),
    (61, 3, 1030, 128, 64, 32),
    (3, 2, 1344, 128, 7, 1),
    (5, 3, 136, 40, 72, 100),
])
def test_cand_score_stash_and_bwd_match_reference(card, dtype, shape):
    if dtype == torch.float32 and shape[0] > 1000:
        shape = (256,) + shape[1:]  # the CUDA-core branch at a smaller BT
    bt, k = shape[:2]
    operands = [t.to(card) for t in _scorer_inputs(*shape, dtype=dtype, seed=5)]
    before = (cand_scorer.launches, cand_scorer.stash_launches)
    scores, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
    torch.cuda.synchronize()
    assert (cand_scorer.launches, cand_scorer.stash_launches) == (
        before[0], before[1] + 1)
    ref_scores, ref_nc = cand_scorer.cand_score_reference(*operands, return_nc=True)
    assert nc.dtype == dtype and nc.shape == (bt * k, shape[2])
    torch.testing.assert_close(nc.float(), ref_nc.float(), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 8e-3)
    torch.testing.assert_close(scores, ref_scores, rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 2e-2)
    g = torch.randn(bt, k, generator=torch.Generator().manual_seed(6)).to(card)
    before = cand_scorer.bwd_launches
    grads = cand_scorer.cand_score_bwd_kernel(*operands, ref_nc, g)
    torch.cuda.synchronize()
    assert cand_scorer.bwd_launches == before + 1
    ref = cand_scorer.cand_score_bwd_reference(*operands, ref_nc, g)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for name, got, want, operand in zip(SCORER_GRADS, grads, ref, operands):
        assert got.dtype == operand.dtype and got.shape == operand.shape, name
        _close_normwise(got, want, tol, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2688, 50, 1024, 128, 64, 32),  # the compacted G1 train shape
    (13, 7, 40, 24, 16, 8),
    (5, 3, 37, 9, 5, 3),
    (61, 3, 1030, 128, 64, 32),
    (3, 2, 1344, 128, 7, 1),
    (5, 3, 136, 40, 72, 100),
])
def test_cand_score_bwd_recompute_matches_reference(card, dtype, shape):
    """The backward that recomputes nc against its twin (normwise, as the
    stash backward), and against the stash backward on the nc the stash
    forward writes: nc is formed the same way in both, so every gradient has
    the same bits."""
    if dtype == torch.float32 and shape[0] > 1000:
        shape = (256,) + shape[1:]
    bt, k = shape[:2]
    operands = [t.to(card) for t in _scorer_inputs(*shape, dtype=dtype, seed=9)]
    g = torch.randn(bt, k, generator=torch.Generator().manual_seed(10)).to(card)
    before = (cand_scorer.bwd_launches, cand_scorer.bwd_recompute_launches)
    grads = cand_scorer.cand_score_bwd_recompute_kernel(*operands, g)
    torch.cuda.synchronize()
    assert (cand_scorer.bwd_launches, cand_scorer.bwd_recompute_launches) == (
        before[0], before[1] + 1)
    ref = cand_scorer.cand_score_bwd_reference(*operands, None, g)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for name, got, want, operand in zip(SCORER_GRADS, grads, ref, operands):
        assert got.dtype == operand.dtype and got.shape == operand.shape, name
        _close_normwise(got, want, tol, name)
    _, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
    stash = cand_scorer.cand_score_bwd_kernel(*operands, nc, g)
    torch.cuda.synchronize()
    for name, got, want in zip(SCORER_GRADS, grads, stash):
        assert torch.equal(got, want), name


@pytest.mark.parametrize("shape,return_nc", [
    ((4864, 50, 1024, 128, 64, 32), False),  # K1f at the G1 eval shape
    ((2688, 50, 1024, 128, 64, 32), True),  # K1fs at the compacted train shape
])
def test_cand_score_fwd_is_deterministic(card, shape, return_nc):
    """Two launches of the forward give the same bits: the two warpgroups'
    first-layer partials are summed in a fixed order, with no atomics."""
    operands = [t.to(card) for t in _scorer_inputs(*shape, torch.bfloat16, seed=15)]
    first = cand_scorer.cand_score_kernel(*operands, return_nc=return_nc)
    second = cand_scorer.cand_score_kernel(*operands, return_nc=return_nc)
    torch.cuda.synchronize()
    for a, b in zip(*((first, second) if return_nc else ((first,), (second,)))):
        assert torch.equal(a, b)


def _library_fn(source, name, n_args):
    import ctypes
    from chameleon_recsys_tpu_torch.ops.kernels import build

    fn = getattr(build.load(source), name)
    fn.argtypes = [ctypes.c_int] * n_args
    fn.restype = ctypes.c_longlong
    return fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_limits_mirror_the_forward_source(card, dtype):
    """The forward refuses exactly the widths ``kernel_takes`` refuses (the
    library's ``cand_score_fwd_smem_bytes`` is -1 there), and in f32 the
    predicate's shared-memory bytes are the library's own."""
    fn = _library_fn("cand_score_fwd", "cand_score_fwd_smem_bytes", 5)
    code = 1 if dtype == torch.bfloat16 else 0
    for c in (8, 64, 512, 1024, 1088, 1280, 1288, 1344, 1536, 1544, 2048, 2688, 2752,
              2880):
        for m1, m2, m3 in ((16, 8, 8), (128, 64, 32), (128, 128, 128), (128, 64, 136),
                           (136, 8, 8), (16, 1024, 1024)):
            takes = cand_scorer.kernel_takes(c, m1, m2, m3, dtype)
            n = fn(c, m1, m2, m3, code)
            assert takes == (n >= 0), (c, m1, m2, m3)
            if takes and dtype == torch.float32:
                assert n == cand_scorer._f32_fwd_smem_bytes(c, m1, m2, m3), (c, m1, m2, m3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_limits_mirror_the_backward_source(card, dtype):
    """The predicate's bytes of the backward's row kernel are the library's
    own (``cand_score_bwd_rows_smem_bytes``) across a grid of matching
    widths, and with ``train`` it refuses every width whose row kernel does
    not fit a block's shared memory."""
    fn = _library_fn("cand_score_bwd", "cand_score_bwd_rows_smem_bytes", 4)
    code = 1 if dtype == torch.bfloat16 else 0
    for m1 in (8, 16, 40, 64, 72, 120, 128):
        for m2 in (1, 8, 16, 64, 72, 100, 128, 512, 1024):
            for m3 in (1, 8, 32, 40, 48, 100, 128, 1024):
                n = fn(m1, m2, m3, code)
                assert n == cand_scorer._bwd_smem_bytes(m1, m2, m3, dtype), (m1, m2, m3)
                if n > cand_scorer._SMEM_LIMIT:
                    assert not cand_scorer.kernel_takes(32, m1, m2, m3, dtype, train=True)
    assert fn(129, 8, 8, code) == -1


def test_cand_score_bwd_is_deterministic(card):
    """Two launches of the backward on the same operands at the compacted G1
    train shape give the same bits: every sum runs in a fixed order, with no
    float atomics."""
    operands = [t.to(card) for t in _scorer_inputs(2688, 50, 1024, 128, 64, 32,
                                                    torch.bfloat16, seed=13)]
    g = torch.randn(2688, 50, generator=torch.Generator().manual_seed(14)).to(card)
    _, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
    first = cand_scorer.cand_score_bwd_kernel(*operands, nc, g)
    second = cand_scorer.cand_score_bwd_kernel(*operands, nc, g)
    torch.cuda.synchronize()
    for name, a, b in zip(SCORER_GRADS, first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("trans_b", [False, True], ids=["b_kmajor", "b_mnmajor"])
@pytest.mark.parametrize("trans_a", [False, True], ids=["a_kmajor", "a_mnmajor"])
@pytest.mark.parametrize("m,n,k", [(1000, 40, 40), (1000, 40, 1000), (40, 40, 1000)])
def test_gemm_core_matches_matmul(card, m, n, k, trans_a, trans_b):
    """The backward's wgmma + TMA GEMM core against torch.matmul of the same
    bf16 operands in f32: a ragged row count (1,000 is no multiple of the
    128-row tile), C = 40 (one partial 128-wide tile, no multiple of 64),
    both operand majors.  The core rounds its f32 sum to bf16 once, so it is
    held at one bf16 rounding of the largest |ref| plus f32 noise."""
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(*((k, m) if trans_a else (m, k)), generator=g).to(torch.bfloat16)
    b = torch.randn(*((k, n) if trans_b else (n, k)), generator=g).to(torch.bfloat16)
    a, b = a.to(card), b.to(card)
    out = cand_scorer.sm90_gemm_kernel(a, b, trans_a, trans_b)
    torch.cuda.synchronize()
    ref = (a.float().T if trans_a else a.float()) @ (b.float() if trans_b else b.float().T)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    scale = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    assert err <= 2.0 ** -8 * scale + 1e-3, (err, scale)


def test_cand_score_function_without_stash_on_card(card, monkeypatch):
    """With ``_STASH_NC`` off, ``CandScore`` launches the eval forward and
    the recompute backward, and its gradients are the CPU's."""
    monkeypatch.setattr(cand_scorer, "_STASH_NC", False)
    operands = _scorer_inputs(13, 7, 40, 24, 16, 8, torch.float32, seed=11)
    g = torch.randn(13, 7, generator=torch.Generator().manual_seed(12))
    grads = {}
    for device in ("cpu", card):
        leaves = [t.detach().clone().to(device).requires_grad_() for t in operands]
        before = (cand_scorer.launches, cand_scorer.stash_launches,
                  cand_scorer.bwd_launches, cand_scorer.bwd_recompute_launches)
        (cand_scorer.cand_score(*leaves) * g.to(device)).sum().backward()
        after = (cand_scorer.launches, cand_scorer.stash_launches,
                 cand_scorer.bwd_launches, cand_scorer.bwd_recompute_launches)
        if device == card:
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(after, before)] == [1, 0, 0, 1]
        grads[str(device)] = [t.grad.cpu() for t in leaves]
    for name, got, want in zip(SCORER_GRADS, grads[str(card)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-6, msg=name)


def test_cand_score_function_on_card_matches_cpu(card):
    operands = _scorer_inputs(13, 7, 40, 24, 16, 8, torch.float32, seed=7)
    g = torch.randn(13, 7, generator=torch.Generator().manual_seed(8))
    grads = {}
    for device in ("cpu", card):
        leaves = [t.detach().clone().to(device).requires_grad_() for t in operands]
        (cand_scorer.cand_score(*leaves) * g.to(device)).sum().backward()
        grads[str(device)] = [t.grad.cpu() for t in leaves]
    for name, got, want in zip(SCORER_GRADS, grads[str(card)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-6, msg=name)


def test_cand_score_kernel_rejects_what_it_cannot_take(card):
    operands = [t.to(card) for t in _scorer_inputs(4, 3, 32, 16, 8, 8, torch.float32)]
    with pytest.raises(TypeError):
        cand_scorer.cand_score_kernel(operands[0].to(torch.bfloat16), *operands[1:])
    with pytest.raises(ValueError):  # a view that is not contiguous
        cand_scorer.cand_score_kernel(
            operands[0], operands[1], operands[2], operands[3].T, *operands[4:]
        )
    # each limit raises before any launch, naming itself (``kernel_limit``)
    for shape, dtype, limit in (
        ((2, 2, 32, 129, 8, 8), torch.float32, "first matching layer has 129"),
        ((2, 2, 32, 256, 8, 8), torch.bfloat16, "first matching layer has 256"),
        ((2, 2, 1544, 128, 8, 8), torch.bfloat16, "C up to 1536, not 1544"),
        ((2, 2, 2752, 128, 8, 8), torch.float32, "f32 forward needs"),
        ((2, 2, 32, 16, 136, 8), torch.bfloat16, "second and third matching layers"),
    ):
        wide = [t.to(card) for t in _scorer_inputs(*shape, dtype)]
        before = (cand_scorer.launches, cand_scorer.stash_launches)
        with pytest.raises(ValueError, match=limit):
            cand_scorer.cand_score_kernel(*wide)
        with pytest.raises(ValueError, match=limit):
            cand_scorer.cand_score_kernel(*wide, return_nc=True)
        assert (cand_scorer.launches, cand_scorer.stash_launches) == before
    # the backward's own limit: M2 = M3 = 1,024 fit the f32 forward, not it
    wide = [t.to(card) for t in _scorer_inputs(2, 2, 32, 16, 1024, 1024, torch.float32)]
    _, nc = cand_scorer.cand_score_kernel(*wide, return_nc=True)
    with pytest.raises(ValueError, match="backward's row kernel"):
        cand_scorer.cand_score_bwd_kernel(*wide, nc, torch.ones(2, 2, device=card))


def _tiny_eval_world():
    """A small float32 configuration that reaches the fused scorer."""
    FeatureSpec = port.FeatureSpec
    article_schema = port.ArticleFeaturesSchema(features=(
        FeatureSpec("article_id", "categorical", 200),
        FeatureSpec("created_at_ts", "numerical", dtype="int"),
        FeatureSpec("category_id", "categorical", 12),
    ))
    session_schema = port.SessionFeaturesSchema(sequence=(
        FeatureSpec("event_timestamp", "numerical", dtype="int"),
        FeatureSpec("item_clicked", "categorical", 200),
        FeatureSpec("device", "categorical", 5),
        FeatureSpec("hour_sin", "numerical", dtype="float"),
    ))
    cfg = port.NARConfig(
        car_embedding_size=32, rnn_units=24, rnn_num_layers=2,
        matching_layer_sizes=(16, 8, 8), eval_negative_samples=5,
        eval_negative_sample_from_buffer=30, recent_clicks_buffer_max_size=128,
        recent_clicks_for_normalization=64, batch_size=8, max_session_length=8,
        metrics_top_n=4, use_pallas_scorer=True, use_pallas_rnn=True,
    )
    return cfg, session_schema, article_schema


def test_eval_step_on_card_matches_cpu(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sess, art = _tiny_eval_world()
    corpus = make_synthetic_corpus(art, ace_dim=8)
    model = port.NARModel(cfg, sess, art, 8)
    model.reset_parameters(torch.Generator().manual_seed(0))
    warm = collate_sessions(
        synthetic_hour_sessions(corpus, sess, 0, 8, 8), sess, 8, 8
    )
    batch = collate_sessions(synthetic_hour_sessions(corpus, sess, 1, 8, 8), sess, 8, 8)
    rng = np.random.RandomState(3)
    nc = min(5 * cfg.neg_sampling_multiplying_factor, 8 * 8 + 30)
    uniforms = SamplerUniforms(*(
        torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
        for shape in ((128,), (8 * 8 + 30,), (8, 8, nc))
    ))
    results = {}
    for device in ("cpu", card):
        on = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        stream = init_stream_state(cfg, 200, device=device)
        stream = update_stream_state(stream, *_batch_all_clicks(
            {k: torch.from_numpy(v).to(device) for k, v in warm.items()}
        ), cfg)
        metadata = {k: torch.from_numpy(np.asarray(v)).to(device)
                    for k, v in corpus.metadata.items()}
        before = (cand_scorer.launches, ugrnn.launches)
        results[str(device)] = eval_step(
            model.to(device), stream, on, torch.from_numpy(corpus.ace_matrix).to(device),
            metadata, generator=torch.Generator(device=device),
            uniforms=SamplerUniforms(*(u.to(device) for u in uniforms)),
        )
        if device == card:
            torch.cuda.synchronize()
            assert (cand_scorer.launches, ugrnn.launches) == (
                before[0] + 1, before[1] + cfg.rnn_num_layers
            )
    (cpu_stream, cpu_metrics, cpu_fetches), (gpu_stream, gpu_metrics, gpu_fetches) = (
        results["cpu"], results[str(card)]
    )
    cpu_probs = cpu_fetches["predicted_probs"]
    torch.testing.assert_close(gpu_fetches["predicted_probs"].cpu(), cpu_probs,
                               rtol=1e-4, atol=1e-6)
    gaps = (cpu_probs[..., 1:] - cpu_probs[..., :-1]).abs()
    separated = torch.ones(cpu_probs.shape, dtype=torch.bool)
    separated[..., 1:] &= gaps > 1e-5
    separated[..., :-1] &= gaps > 1e-5
    assert torch.equal(gpu_fetches["predicted_ids"].cpu()[separated],
                       cpu_fetches["predicted_ids"][separated])
    for key in ("labels", "neg_items", "clicked_items"):
        assert torch.equal(gpu_fetches[key].cpu(), cpu_fetches[key]), key
    for key in ("hit_sum", "label_count", "clicks", "sessions"):
        assert float(gpu_metrics[key]) == float(cpu_metrics[key]), key
    assert float(gpu_metrics["ce_loss"]) == pytest.approx(
        float(cpu_metrics["ce_loss"]), rel=1e-4
    )
    for name, value in cpu_stream._asdict().items():
        assert torch.equal(getattr(gpu_stream, name).cpu(), value), name


def _steps_on(device, cfg, sess, art, corpus, seed):
    """One eval step and one train step (with compaction) of a fresh model
    on ``device``, with uniforms drawn by numpy from ``seed``: the eval
    step's metrics and fetches, the train step's metrics and gradients, and
    the fused scorer's launches over both."""
    b, length = cfg.batch_size, cfg.max_session_length
    warm = collate_sessions(synthetic_hour_sessions(corpus, sess, 0, b, length), sess, b, length)
    batch = collate_sessions(synthetic_hour_sessions(corpus, sess, 1, b, length), sess, b, length)
    on = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    ace = torch.from_numpy(corpus.ace_matrix).to(device)
    metadata = {k: torch.from_numpy(np.asarray(v)).to(device)
                for k, v in corpus.metadata.items()}
    rng = np.random.RandomState(seed)
    buffer, pool = cfg.recent_clicks_buffer_max_size, b * length + 30
    rows = cfg.train_valid_row_capacity

    def uniforms(*click):
        return SamplerUniforms(*(torch.from_numpy(u).to(device) for u in (
            rng.uniform(size=(buffer,)).astype(np.float32),
            rng.uniform(size=(pool,)).astype(np.float32),
            rng.uniform(size=click).astype(np.float32))))

    def stream():
        s = init_stream_state(cfg, 200, device=device)
        return update_stream_state(s, *_batch_all_clicks(
            {k: torch.from_numpy(v).to(device) for k, v in warm.items()}), cfg)

    model = port.NARModel(cfg, sess, art, 8)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device)
    counters = ("launches", "stash_launches", "bwd_launches", "bwd_recompute_launches")
    before = [getattr(cand_scorer, n) for n in counters]
    nc_eval = min(cfg.eval_negative_samples * cfg.neg_sampling_multiplying_factor, pool)
    _, eval_metrics, fetches = eval_step(model, stream(), on, ace, metadata,
                                         generator=torch.Generator(device=device),
                                         uniforms=uniforms(b, length, nc_eval))
    nc_train = min(cfg.negative_samples * cfg.neg_sampling_multiplying_factor, pool)
    _, train_metrics = train_step(
        init_train_state(model, stream(), torch.Generator(device=device)), on, ace,
        metadata, uniforms=uniforms(rows, nc_train))
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    if device != "cpu":
        torch.cuda.synchronize()
    launched = [getattr(cand_scorer, n) - v for n, v in zip(counters, before)]
    return eval_metrics, fetches, train_metrics, grads, launched


def _steps_on_card_and_cpu(card, dtype, **widths):
    """An eval step and a train step of the tiny world at these widths in
    ``dtype``, on the CPU and on the card: (cpu, card) as ``_steps_on``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sess, art = _tiny_eval_world()
    if dtype == torch.bfloat16:
        widths["compute_dtype"] = "bfloat16"
    cfg = dataclasses.replace(cfg, train_valid_row_capacity=48, negative_samples=5,
                              negative_sample_from_buffer=30, **widths)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    return cfg, _steps_on("cpu", cfg, sess, art, corpus, seed=3), _steps_on(
        card, cfg, sess, art, corpus, seed=3)


def _assert_steps_match(cpu, gpu, dtype):
    """float32 at the tolerances of ``test_eval_step_on_card_matches_cpu``
    (probabilities rtol 1e-4 / atol 1e-6, losses rel 1e-4, each gradient
    within 1e-4 of its norm + 1e-5); bf16 probabilities at 2e-2 (as the bf16
    eval test of the JAX package's scorer) and losses at rel 2e-2.  bf16
    gradients are not compared: the card and the CPU round bf16 products at
    other places, and the first layer's gradient sums them over every row,
    so their gap says little; the f32 case holds the gradients."""
    bf16 = dtype == torch.bfloat16
    prob_tol = dict(rtol=0, atol=2e-2) if bf16 else dict(rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gpu[1]["predicted_probs"].cpu(), cpu[1]["predicted_probs"],
                               **prob_tol)
    for key in ("label_count", "clicks", "sessions"):
        assert float(gpu[0][key]) == float(cpu[0][key]), key
    rel = 2e-2 if bf16 else 1e-4
    assert float(gpu[0]["ce_loss"]) == pytest.approx(float(cpu[0]["ce_loss"]), rel=rel)
    for key in ("loss", "ce_loss"):
        assert float(gpu[2][key]) == pytest.approx(float(cpu[2][key]), rel=rel), key
    for name, g in cpu[3].items():
        assert torch.isfinite(gpu[3][name]).all(), name
        if not bf16:
            assert (gpu[3][name] - g).norm() <= 1e-4 * g.norm() + 1e-5, name


@pytest.mark.parametrize("case", ["m1_256_f32", "c1600_bf16"])
def test_steps_at_widths_the_kernels_refuse_run_on_card(card, case):
    """A first matching layer of 256 units (float32), and a bf16 C of 1,600
    (past the forward's 1,536): the gate takes the plain branch, so an eval
    step and a train step run on the card without raising and launch no
    scorer kernel, and they match the CPU (``_assert_steps_match``)."""
    if case == "m1_256_f32":
        dtype, widths = torch.float32, dict(matching_layer_sizes=(256, 8, 8))
    else:
        dtype, widths = torch.bfloat16, dict(car_embedding_size=1600)
    cfg, cpu, gpu = _steps_on_card_and_cpu(card, dtype, **widths)
    assert not cand_scorer.kernel_takes(cfg.car_embedding_size, *cfg.matching_layer_sizes,
                                        dtype)
    assert gpu[4] == [0, 0, 0, 0]  # the plain branch
    _assert_steps_match(cpu, gpu, dtype)


def test_steps_at_a_bf16_c_past_1280_launch_the_kernels_on_card(card):
    """A bf16 C of 1,344, which the forward's rings take with one stage a
    warpgroup: the gate takes the fused branch, the eval step launches K1f
    once and the train step K1fs and K1b once each, and they match the CPU
    (``_assert_steps_match``)."""
    cfg, cpu, gpu = _steps_on_card_and_cpu(card, torch.bfloat16, car_embedding_size=1344)
    assert cand_scorer.kernel_takes(1344, *cfg.matching_layer_sizes, torch.bfloat16,
                                    train=True)
    assert gpu[4] == [1, 1, 1, 0]
    _assert_steps_match(cpu, gpu, torch.bfloat16)
