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

from test_adressa_cli import raw  # noqa: F401  (the tiny raw fixture; no JAX)

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
        shape = (256,) + shape[1:]  # the split-TF32 branch at a smaller BT
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
    the same bits.  In f32 the twin runs on that nc too: the twin's own nc
    (cuBLAS's f32 product) lies up to 2.6e-6 from the exactly rounded one
    and flips leaky' of a pre-activation within that of 0, so that even the
    twin on the exactly rounded nc lies beyond 2e-4 of the twin's recompute
    at the 256-row shape (``scripts/scorer_f32_accuracy.py``): no forward
    that does not repeat cuBLAS's summation order can meet it; the
    forward's nc is held to the twin's within 1e-5 by the stash test."""
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
    _, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
    ref = cand_scorer.cand_score_bwd_reference(
        *operands, nc if dtype == torch.float32 else None, g)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for name, got, want, operand in zip(SCORER_GRADS, grads, ref, operands):
        assert got.dtype == operand.dtype and got.shape == operand.shape, name
        _close_normwise(got, want, tol, name)
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


@pytest.mark.parametrize("shape", [
    (352, 50, 1024, 128, 64, 32),  # the quality example B's f32 step
    (61, 3, 1030, 128, 64, 32),  # N = 183, no multiple of 64; C no multiple of 32
    (7, 9, 200, 8, 8, 8),  # the narrowest matching widths, C of 3.125 tiles
    (5, 13, 100, 72, 40, 24),  # M1 past 64 (two W1 halves), N = 65
    (2, 33, 1000, 64, 16, 8),  # one W1 half, C = 1000
    (3, 7, 2688, 128, 64, 32),  # the widest C the CUDA-core forward took
])
def test_f32_kernels_match_reference(card, shape):
    """The split-TF32 forward (without and with the stash) and backward
    against their twins at B's shape and ragged ones: scores and nc within
    1e-5, the 12 gradients 2e-4 normwise (``chip_smoke.py``'s f32 checks),
    each call counted once."""
    bt, k = shape[:2]
    operands = [t.to(card) for t in _scorer_inputs(*shape, torch.float32, seed=21)]
    before = (cand_scorer.launches, cand_scorer.stash_launches, cand_scorer.bwd_launches)
    scores = cand_scorer.cand_score_kernel(*operands)
    stash_scores, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
    ref_scores, ref_nc = cand_scorer.cand_score_reference(*operands, return_nc=True)
    g = (torch.randn(bt, k, generator=torch.Generator().manual_seed(22)) / (bt * 0.1)).to(card)
    grads = cand_scorer.cand_score_bwd_kernel(*operands, ref_nc, g)
    ref = cand_scorer.cand_score_bwd_reference(*operands, ref_nc, g)
    torch.cuda.synchronize()
    assert (cand_scorer.launches, cand_scorer.stash_launches, cand_scorer.bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    for got in (scores, stash_scores):
        torch.testing.assert_close(got, ref_scores, rtol=0, atol=1e-5)
    torch.testing.assert_close(nc, ref_nc, rtol=0, atol=1e-5)
    for name, got, want, operand in zip(SCORER_GRADS, grads, ref, operands):
        assert got.dtype == torch.float32 and got.shape == operand.shape, name
        _close_normwise(got, want, 2e-4, name)


def test_f32_kernels_are_deterministic(card):
    """Two launches of the split-TF32 forward and backward at B's shape give
    the same bits: the scores, the stash forward's scores and nc, and all 12
    gradients (partials summed in a fixed order, no float atomics)."""
    operands = [t.to(card) for t in _scorer_inputs(352, 50, 1024, 128, 64, 32,
                                                    torch.float32, seed=23)]
    g = torch.randn(352, 50, generator=torch.Generator().manual_seed(24)).to(card)
    runs = []
    for _ in range(2):
        scores = cand_scorer.cand_score_kernel(*operands)
        stash_scores, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
        grads = cand_scorer.cand_score_bwd_kernel(*operands, nc, g)
        runs.append((scores, stash_scores, nc) + tuple(grads))
    torch.cuda.synchronize()
    for name, a, b in zip(("scores", "stash scores", "nc") + SCORER_GRADS, *runs):
        assert torch.equal(a, b), name


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
                           (136, 8, 8), (16, 1024, 1024), (16, 1808, 1808),
                           (16, 1808, 1809), (128, 1800, 1800)):
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
        ((2, 2, 32, 128, 1800, 1800), torch.float32, "f32 forward needs"),
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


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_train_step_on_card_matches_cpu(card, groups):
    """``train_compaction_groups`` 2 and 4 at capacity 48 (12 or 24 rows a
    group): the train step takes the fused branch through the grouped
    gathers, launching K1fs and K1b once and K2f and K2b twice (two UGRNN
    layers), and matches the CPU (``_assert_steps_match``), its
    ``dropped_clicks`` exactly."""
    before = (ugrnn.launches, ugrnn.bwd_launches)
    cfg, cpu, gpu = _steps_on_card_and_cpu(card, torch.float32,
                                           train_compaction_groups=groups)
    assert gpu[4] == [1, 1, 1, 0]  # eval K1f; train K1fs and K1b
    assert (ugrnn.launches - before[0], ugrnn.bwd_launches - before[1]) == (4, 2)
    assert float(gpu[2]["dropped_clicks"]) == float(cpu[2]["dropped_clicks"])
    _assert_steps_match(cpu, gpu, torch.float32)


def test_steps_past_the_ugrnn_kernels_width_run_on_card(card):
    """1,040 RNN units with ``use_pallas_rnn`` on, past the UGRNN kernels'
    1,024 (``ugrnn.kernel_takes``): the layers run the plain scan, so an
    eval step and a train step run on the card without raising, launch no
    K2f or K2b, and match the CPU (``_assert_steps_match``)."""
    before = (ugrnn.launches, ugrnn.bwd_launches)
    cfg, cpu, gpu = _steps_on_card_and_cpu(card, torch.float32, rnn_units=1040)
    assert cfg.use_pallas_rnn and not ugrnn.kernel_takes(cfg.rnn_units, torch.float32)
    assert (ugrnn.launches, ugrnn.bwd_launches) == before
    _assert_steps_match(cpu, gpu, torch.float32)


# ---------------------------------------------------------------------------
# ACR and the Adressa chain: the card against the CPU.  The port's ACR runs
# float32 with TF32 off (its trainer turns both TF32 flags off around its
# steps), so the card computes the CPU's f32 sums in another order: the
# ACE of the initial weights within 1e-5, one step's gradients within 2e-5
# of each parameter's norm (cuDNN's f32 LSTM backward is the noisiest, some
# 10x torch's own CUDA LSTM) and each of 20 steps' task losses within 1e-4
# relative.  After those 20 Adam steps (lr 1e-3) the ACE agrees within 1e-4
# for the CNN and the GRU (chip_smoke.py's ACR_CARD_TOL for the published
# CNN) and within 1e-3 for the unidirectional LSTM: Adam's normalised step
# turns the gradient noise of near-zero elements into lr-sized moves, and
# cuDNN's LSTM backward gives it the most noise.  scripts/card_cpu_drift.py
# prints each of these readings on the card (PERF.md, PR 9, has them).
# ---------------------------------------------------------------------------

ACR_CARD_TOL = {"loss": 1e-4, "ace": 1e-4}
ACR_FORWARD_TOL = 1e-5  # the ACE at the same weights
ACR_GRAD_TOL = 2e-5  # one step's gradients, normwise
ACR_LSTM_FIT_ACE_TOL = 1e-3


def _acr_corpus(seed=0, n=160, vocab=300, dim=32, length=40):
    rng = np.random.RandomState(seed)
    word_emb = (rng.randn(vocab, dim) * 0.3).astype(np.float32)
    lengths = rng.randint(8, length + 1, n)
    text = np.where(np.arange(length)[None] < lengths[:, None],
                    rng.randint(2, vocab, (n, length)), 0).astype(np.int32)
    articles = {"article_id": np.arange(1, n + 1), "text": text,
                "text_length": lengths.astype(np.int32),
                "category0": rng.randint(1, 12, n), "keywords": rng.randint(0, 20, (n, 4))}
    return word_emb, articles, {"category0": (rng.rand(12) + 0.5).astype(np.float32)}


@pytest.mark.parametrize("extractor,direction", [
    ("CNN", "unidirectional"), ("GRU", "bidirectional"), ("LSTM", "unidirectional")])
def test_acr_train_steps_on_card_match_cpu(card, extractor, direction):
    from chameleon_recsys_tpu_torch.acr.trainer import ACRTrainer
    from chameleon_recsys_tpu_torch.config import ACRConfig
    from chameleon_recsys_tpu_torch.models.acr import ACRLabelSpec

    class RecordingTrainer(ACRTrainer):
        def train_step(self, batch, weights):
            loss, task_loss = super().train_step(batch, weights)
            if not self.task_losses:  # the first step's gradients
                self.grads = {n: p.grad.detach().cpu()
                              for n, p in self.model.named_parameters()}
            self.task_losses.append(task_loss)
            return loss, task_loss

    word_emb, articles, class_weights = _acr_corpus()
    cfg = ACRConfig(text_feature_extractor=extractor, rnn_direction=direction,
                    word_embedding_size=32, vocab_size=300, truncate_tokens_length=40,
                    acr_embeddings_size=24, rnn_units=16, batch_size=8, training_epochs=1,
                    learning_rate=1e-3, l2_reg_lambda=1e-5)
    specs = (ACRLabelSpec("category0", 12, "multiclass"),
             ACRLabelSpec("keywords", 20, "multilabel"))
    torch.backends.cudnn.allow_tf32 = True  # the trainer turns it off for its steps
    runs = {}
    for device in ("cpu", card):
        trainer = RecordingTrainer(cfg, word_emb, specs, class_weights, device=device)
        trainer.task_losses = []
        initial_ace = trainer.predict_all_ace(articles)
        trainer.fit(articles)
        runs[str(device)] = (initial_ace, trainer.grads,
                             torch.stack(trainer.task_losses).cpu().numpy(),
                             trainer.predict_all_ace(articles))
    assert torch.backends.cudnn.allow_tf32  # restored after the steps
    (cpu_ace0, cpu_grads, cpu_losses, cpu_ace), (gpu_ace0, gpu_grads, gpu_losses, gpu_ace) = (
        runs["cpu"], runs[str(card)])
    np.testing.assert_allclose(gpu_ace0, cpu_ace0, rtol=0, atol=ACR_FORWARD_TOL)
    for name, g in cpu_grads.items():
        assert (gpu_grads[name] - g).norm() <= ACR_GRAD_TOL * g.norm(), name
    assert len(cpu_losses) == len(gpu_losses) == 20
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=ACR_CARD_TOL["loss"], atol=0)
    fit_tol = ACR_LSTM_FIT_ACE_TOL if extractor == "LSTM" else ACR_CARD_TOL["ace"]
    np.testing.assert_allclose(gpu_ace, cpu_ace, rtol=0, atol=fit_tol)


# The Adressa NAR trainer on the card against the CPU, 3 hours of Adam
# steps from the same weights and draws: the pooled gather's backward sums
# with atomics on the card (ROADMAP section 3) and Adam turns f32 noise of
# near-zero gradients into lr-sized moves, so the recommended items'
# probabilities part where the ranked ids agree, the more the more steps
# (scripts/card_cpu_drift.py reads it on a longer stream): over this
# fixture's three short hours two candidates whose CPU probabilities lie
# within 1e-3 are a near tie either side may rank first.
NAR_PROB_TOL = 1e-3


def _near_tie_swaps(card_log, cpu_log, gap=NAR_PROB_TOL):
    """Ranked positions where the two recommendation logs differ (each must
    sit in a near tie of the CPU's probabilities, and the probabilities of
    steps ranked alike within ``gap``); returns their count."""
    swaps = 0
    for card_rec, cpu_rec in zip(card_log, cpu_log):
        assert card_rec["session_id"] == cpu_rec["session_id"]
        for c_ids, p_ids, c_probs, p_probs in zip(
                card_rec["predicted_item_ids"], cpu_rec["predicted_item_ids"],
                card_rec["predicted_item_probs"], cpu_rec["predicted_item_probs"]):
            differ = np.flatnonzero(np.asarray(c_ids) != np.asarray(p_ids))
            if not differ.size:
                assert np.max(np.abs(np.subtract(c_probs, p_probs))) <= gap
            for pos in differ:
                assert any(abs(p_probs[pos] - p_probs[q]) <= gap
                           for q in (pos - 1, pos + 1) if 0 <= q < len(p_probs)), (
                    card_rec["session_id"], c_ids, c_probs, p_ids, p_probs)
                swaps += 1
    return swaps


def test_adressa_chain_on_card_matches_cpu(card, raw, tmp_path, monkeypatch):
    """The port's Adressa CLIs over the tiny raw fixture of
    ``tests/test_adressa_cli.py``: ``acr_trainer_adressa`` on the card and
    on the CPU export ACEs within ``ACR_CARD_TOL["ace"]``;
    ``nar_trainer_adressa`` (float32) on the card and on the CPU, from the
    same ACE pickle and with the same sampler uniforms (numpy, one stream
    across the steps), give the same eval rows: the baseline columns equal,
    CHAMELEON's within 1e-6 (widened by one label's share per near tie
    ranked the other way, ``NAR_PROB_TOL``), no kernel launched."""
    import csv
    import json
    import pickle

    from chameleon_recsys_tpu_torch.cli import (
        acr_preprocess_adressa,
        acr_trainer_adressa,
        nar_preprocess_adressa,
        nar_trainer_adressa,
    )
    from chameleon_recsys_tpu_torch.train import steps, temporal

    raw_dir, _ = raw
    torch.backends.cuda.matmul.allow_tf32 = False
    acr_preprocess_adressa.main([
        "--input_articles_json_path", str(raw_dir / "articles.jsonl"),
        "--input_word_embeddings_path", str(raw_dir / "w2v.txt"),
        "--output_dir", str(tmp_path / "acr"), "--truncate_tokens_length", "12",
        "--min_label_freq", "1"])
    aces = {}
    for platform in ("cpu", "cuda"):
        acr_trainer_adressa.main([
            "--train_set_path_regex", str(tmp_path / "acr" / "articles_tokenized_*.tfrecord.gz"),
            "--input_word_vocab_embeddings_path",
            str(tmp_path / "acr" / "acr_word_vocab_embeddings.pickle"),
            "--input_label_encoders_path", str(tmp_path / "acr" / "acr_label_encoders.pickle"),
            "--output_acr_metadata_embeddings_path", str(tmp_path / f"ace_{platform}.pickle"),
            "--text_feature_extractor", "CNN", "--acr_embeddings_size", "8",
            "--batch_size", "8", "--training_epochs", "2", "--learning_rate", "3e-3",
            "--truncate_tokens_length", "12", "--platform", platform])
        aces[platform] = pickle.loads((tmp_path / f"ace_{platform}.pickle").read_bytes())[2]
    np.testing.assert_allclose(aces["cuda"], aces["cpu"], rtol=0, atol=ACR_CARD_TOL["ace"])

    nar_preprocess_adressa.main([
        "--input_clicks_json_path", str(raw_dir / "clicks.jsonl"),
        "--output_sessions_tfrecords_path", str(tmp_path / "s" / "sessions_hour_*.tfrecord.gz"),
        "--output_nar_preprocessing_resources_path", str(tmp_path / "resources.pickle")])
    b, length, buffer, factor = 8, 6, 64, 20
    rows = {}
    for platform in ("cpu", "cuda"):
        rng = np.random.RandomState(5)

        def draw(negatives, from_buffer, device):
            nc = min(negatives * factor, b * length + from_buffer)
            return SamplerUniforms(*(
                torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(device)
                for shape in ((buffer,), (b * length + from_buffer,), (b, length, nc))))

        monkeypatch.setattr(temporal, "train_step", lambda state, batch, ace, meta, **kw: (
            steps.train_step(state, batch, ace, meta, uniforms=draw(3, 16, ace.device),
                             **kw)))
        monkeypatch.setattr(temporal, "eval_step", lambda model, stream, batch, ace, meta,
                            **kw: steps.eval_step(model, stream, batch, ace, meta,
                                                  uniforms=draw(3, 16, ace.device), **kw))
        before = (cand_scorer.launches, ugrnn.launches)
        model_dir = tmp_path / f"model_{platform}"
        nar_trainer_adressa.main([
            "--train_set_path_regex", str(tmp_path / "s" / "sessions_hour_*.tfrecord.gz"),
            "--acr_module_resources_path", str(tmp_path / "ace_cpu.pickle"),
            "--nar_module_preprocessing_resources_path", str(tmp_path / "resources.pickle"),
            "--model_dir", str(model_dir), "--training_hours_for_each_eval", "1",
            "--batch_size", str(b), "--truncate_session_length", str(length),
            "--CAR_embedding_size", "16", "--rnn_units", "10",
            "--train_total_negative_samples", "3", "--train_negative_samples_from_buffer", "16",
            "--eval_total_negative_samples", "3", "--eval_negative_samples_from_buffer", "16",
            "--eval_metrics_top_n", "3", "--recent_clicks_buffer_max_size", str(buffer),
            "--recent_clicks_for_normalization", "32", "--compute_dtype", "float32",
            "--save_eval_sessions_recommendations", "--platform", platform])
        assert (cand_scorer.launches, ugrnn.launches) == before  # the plain branch
        with open(model_dir / "eval_stats_benchmarks.csv") as f:
            rows[platform] = list(csv.DictReader(f))
        rows[platform + "_log"] = [json.loads(line) for line in (
            model_dir / "eval_chameleon_recommendations_log.json").read_text().splitlines()]
    assert len(rows["cpu"]) == len(rows["cuda"]) == 2
    swaps = _near_tie_swaps(rows["cuda_log"], rows["cpu_log"])
    for gpu_row, cpu_row in zip(rows["cuda"], rows["cpu"]):
        assert list(gpu_row) == list(cpu_row)
        tol = 1e-6 + swaps / int(cpu_row["clicks_count"])
        for key, value in cpu_row.items():
            if key.endswith("_chameleon") or key in ("hitrate_at_n", "mrr_at_n"):
                assert float(gpu_row[key]) == pytest.approx(float(value), abs=tol), key
            elif not key.endswith(("elapsed_s", "per_s")):
                assert gpu_row[key] == value, key


def _seeded_masks(monkeypatch, seed):
    """Dropout masks and autoencoder noise from numpy, call by call: the CPU
    run and the card run draw the same ones."""
    from chameleon_recsys_tpu_torch.models import acr as acr_models
    from chameleon_recsys_tpu_torch.ops import dropout as dropout_module

    rng = np.random.RandomState(seed)
    monkeypatch.setattr(dropout_module, "_draw_mask", lambda shape, keep, generator, device:
                        torch.from_numpy(rng.rand(*shape) < keep).to(device))
    monkeypatch.setattr(acr_models, "_draw_noise", lambda shape, generator, device:
                        torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device))


@pytest.mark.parametrize("capacity", [48, None], ids=["rows", "grid"])
def test_dense_dropout_train_step_on_card_matches_cpu(card, capacity, monkeypatch):
    """A train step at keep_prob 0.8 (the dense path) with the same masks and
    uniforms on the CPU and on the card: K2f and K2b twice each on the card,
    no fused-scorer kernel; the losses within 1e-4 and every gradient within
    1e-4 of its norm, as ``_assert_steps_match``'s float32 case."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sess, art = _tiny_eval_world()
    cfg = dataclasses.replace(cfg, keep_prob=0.8, train_valid_row_capacity=capacity,
                              negative_samples=5, negative_sample_from_buffer=30)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    b, length = cfg.batch_size, cfg.max_session_length
    warm = collate_sessions(synthetic_hour_sessions(corpus, sess, 0, b, length), sess, b, length)
    batch = collate_sessions(synthetic_hour_sessions(corpus, sess, 1, b, length), sess, b, length)
    pool = b * length + 30
    nc = min(5 * cfg.neg_sampling_multiplying_factor, pool)
    rng = np.random.RandomState(4)
    uniforms = SamplerUniforms(*(torch.from_numpy(rng.uniform(size=s).astype(np.float32))
                                 for s in ((128,), (pool,),
                                           (capacity, nc) if capacity else (b, length, nc))))
    results = {}
    for device in ("cpu", card):
        _seeded_masks(monkeypatch, 5)
        model = port.NARModel(cfg, sess, art, 8)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(device)
        stream = update_stream_state(init_stream_state(cfg, 200, device=device),
                                     *_batch_all_clicks({k: torch.from_numpy(v).to(device)
                                                         for k, v in warm.items()}), cfg)
        counts = [cand_scorer.launches, cand_scorer.stash_launches, cand_scorer.bwd_launches,
                  cand_scorer.bwd_recompute_launches, ugrnn.launches, ugrnn.bwd_launches]
        _, metrics = train_step(
            init_train_state(model, stream, torch.Generator(device=device)),
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
            torch.from_numpy(corpus.ace_matrix).to(device),
            {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in corpus.metadata.items()},
            uniforms=SamplerUniforms(*(u.to(device) for u in uniforms)))
        if device == card:
            torch.cuda.synchronize()
            counts = [n - c for n, c in zip(
                [cand_scorer.launches, cand_scorer.stash_launches, cand_scorer.bwd_launches,
                 cand_scorer.bwd_recompute_launches, ugrnn.launches, ugrnn.bwd_launches],
                counts)]
            assert counts == [0, 0, 0, 0, 2, 2], counts
        results[str(device)] = (metrics, {n: p.grad.detach().cpu()
                                          for n, p in model.named_parameters()})
    (cpu_metrics, cpu_grads), (gpu_metrics, gpu_grads) = results["cpu"], results[str(card)]
    for key in ("loss", "ce_loss"):
        assert float(gpu_metrics[key]) == pytest.approx(float(cpu_metrics[key]), rel=1e-4)
    for name, g in cpu_grads.items():
        assert (gpu_grads[name] - g).norm() <= 1e-4 * g.norm() + 1e-5, name


@pytest.mark.parametrize("direction", ["unidirectional", "bidirectional"])
def test_acr_autoencoder_steps_on_card_match_cpu(card, direction, monkeypatch):
    """20 autoencoder steps (two GRU layers, noise 0.05 and dropout 0.8 from
    the same numpy draws) from the same weights on the CPU and on the card:
    the task losses and the ACE at the tolerances of the ACR card test."""
    from chameleon_recsys_tpu_torch.acr.trainer import ACRTrainer
    from chameleon_recsys_tpu_torch.config import ACRConfig

    class RecordingTrainer(ACRTrainer):
        def train_step(self, batch, weights):
            loss, task_loss = super().train_step(batch, weights)
            self.task_losses.append(task_loss)
            return loss, task_loss

    word_emb, articles, _ = _acr_corpus()
    articles = {k: articles[k] for k in ("article_id", "text", "text_length")}
    cfg = ACRConfig(training_task="autoencoder", text_feature_extractor="GRU",
                    rnn_direction=direction, rnn_layers=2, rnn_units=16,
                    autoencoder_noise=0.05, dropout_keep_prob=0.8, word_embedding_size=32,
                    vocab_size=300, truncate_tokens_length=40, acr_embeddings_size=24,
                    batch_size=8, training_epochs=1, learning_rate=1e-3, l2_reg_lambda=1e-5)
    runs = {}
    for device in ("cpu", card):
        _seeded_masks(monkeypatch, 6)
        trainer = RecordingTrainer(cfg, word_emb, device=device)
        trainer.task_losses = []
        trainer.fit(articles)
        runs[str(device)] = (torch.stack(trainer.task_losses).cpu().numpy(),
                             trainer.build_ace_matrix(articles))
    (cpu_losses, cpu_ace), (gpu_losses, gpu_ace) = runs["cpu"], runs[str(card)]
    assert len(cpu_losses) == 20 and np.isfinite(cpu_losses).all()
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=ACR_CARD_TOL["loss"], atol=0)
    np.testing.assert_allclose(gpu_ace, cpu_ace, rtol=0, atol=ACR_CARD_TOL["ace"])


# ACR in bfloat16 on the card against the CPU: the tolerances of
# tests/test_torch_acr_bf16.py (the port's bf16 against JAX's), since the
# card's cuBLAS and cuDNN convolutions round the bf16 products at other
# places than the CPU's, as XLA does: activations (the ACE, the matrix)
# within 2e-2 normwise, the f32 losses within 1e-3 relative, all
# parameters together within 5e-3 of their norm after three Adam steps.
ACR_BF16_TOL = {"act": 2e-2, "loss": 1e-3, "params": 5e-3}


def _rel(a, b):
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("task", ["CNN", "GRU", "LSTM", "autoencoder"])
def test_acr_bf16_steps_on_card_match_cpu(card, task):
    """Three bf16 steps (24 articles at batch 8) of a classifier or the GRU
    autoencoder from the same weights on the CPU and on the card: the ACE of
    the initial weights, the task losses, the parameters (f32) and the ACE
    matrix after the steps."""
    from chameleon_recsys_tpu_torch.acr.trainer import ACRTrainer
    from chameleon_recsys_tpu_torch.config import ACRConfig
    from chameleon_recsys_tpu_torch.models.acr import ACRLabelSpec

    class RecordingTrainer(ACRTrainer):
        def train_step(self, batch, weights):
            loss, task_loss = super().train_step(batch, weights)
            self.task_losses.append(task_loss)
            return loss, task_loss

    word_emb, articles, class_weights = _acr_corpus(n=24)
    autoencoder = task == "autoencoder"
    cfg = ACRConfig(training_task="autoencoder" if autoencoder else "metadata_classification",
                    text_feature_extractor="GRU" if autoencoder else task,
                    rnn_direction="bidirectional" if task == "GRU" else "unidirectional",
                    word_embedding_size=32, vocab_size=300, truncate_tokens_length=40,
                    acr_embeddings_size=24, rnn_units=16, rnn_layers=2, batch_size=8,
                    training_epochs=1, learning_rate=1e-3, l2_reg_lambda=1e-5,
                    compute_dtype="bfloat16")
    specs = () if autoencoder else (ACRLabelSpec("category0", 12, "multiclass"),
                                    ACRLabelSpec("keywords", 20, "multilabel"))
    if autoencoder:
        articles = {k: articles[k] for k in ("article_id", "text", "text_length")}
        class_weights = None
    runs = {}
    for device in ("cpu", card):
        trainer = RecordingTrainer(cfg, word_emb, specs, class_weights, device=device)
        trainer.task_losses = []
        initial_ace = trainer.predict_all_ace(articles)
        trainer.fit(articles)
        params = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
        runs[str(device)] = (initial_ace, torch.stack(trainer.task_losses).cpu().numpy(),
                             params, trainer.build_ace_matrix(articles))
    (cpu_ace0, cpu_losses, cpu_params, cpu_ace), (gpu_ace0, gpu_losses, gpu_params, gpu_ace) = (
        runs["cpu"], runs[str(card)])
    assert gpu_ace0.dtype == np.float32 and np.isfinite(gpu_losses).all()
    assert all(p.dtype == torch.float32 for p in gpu_params.values())
    assert _rel(gpu_ace0, cpu_ace0) <= ACR_BF16_TOL["act"]
    assert len(cpu_losses) == len(gpu_losses) == 3
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=ACR_BF16_TOL["loss"], atol=0)
    flat = [torch.cat([p.flatten() for _, p in sorted(d.items())]) for d in (gpu_params,
                                                                              cpu_params)]
    assert _rel(flat[0].numpy(), flat[1].numpy()) <= ACR_BF16_TOL["params"]
    assert _rel(gpu_ace, cpu_ace) <= ACR_BF16_TOL["act"]


# ---------------------------------------------------------------------------
# The neural baselines and the device-time helpers on the card.  GRU4Rec and
# SR-GNN initialise from a CPU generator, so the card and the CPU start from
# the same weights; both draw the same negatives (GRU4Rec's replaced by one
# numpy draw, SR-GNN's numpy draws from one seed).  float32 with TF32 off:
# each step's loss within rel 1e-5 and each parameter within 1e-5 of its
# norm (the same f32 arithmetic summed in another order).
# ---------------------------------------------------------------------------

NEURAL_CARD_TOL = 1e-5


def _neural_batches(n_items, steps, b=16, t=8, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        items = rng.randint(1, n_items, size=(b, t))
        labels = rng.randint(1, n_items, size=(b, t))
        lengths = rng.randint(1, t + 1, size=b)
        pad = np.arange(t)[None, :] >= lengths[:, None]
        items[pad], labels[pad] = 0, 0
        out.append((items, labels, rng.randint(0, n_items, size=300)))
    return out


def _assert_params_match(card_params, cpu_params):
    for (name, p), (_, ref) in zip(card_params.named_parameters(),
                                   cpu_params.named_parameters()):
        diff = (p.detach().cpu() - ref.detach()).norm()
        assert diff <= NEURAL_CARD_TOL * ref.detach().norm() + 1e-7, name


def test_gru4rec_steps_on_card_match_cpu(card, monkeypatch):
    from chameleon_recsys_tpu_torch.baselines import gru4rec

    torch.backends.cuda.matmul.allow_tf32 = False
    draws = np.random.RandomState(1)
    indices = []
    monkeypatch.setattr(gru4rec, "_draw_negative_indices",
                        lambda n, n_valid, g: torch.from_numpy(indices.pop(0)).to(g.device))
    batches = _neural_batches(500, 4)
    picks = [draws.randint(0, (buf != 0).sum(), size=32) for _, _, buf in batches]
    runs = []
    for device in ("cpu", card):
        model = gru4rec.GRU4Rec(500, layers=(48, 32), n_sample=32, dropout_p_hidden=0.0,
                                seed=3, device=device)
        indices[:] = [p.copy() for p in picks]
        losses = [float(model.fit_batch(*batch)) for batch in batches]
        runs.append((losses, model))
    (cpu_losses, cpu_model), (card_losses, card_model) = runs
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=NEURAL_CARD_TOL)
    _assert_params_match(card_model.params, cpu_model.params)
    neg = np.random.RandomState(2).randint(0, 500, size=batches[0][1].shape + (10,))
    ranked = card_model.rank_candidates(batches[0][0], batches[0][1], neg)
    assert ranked.shape == neg.shape[:2] + (11,)


def test_srgnn_steps_on_card_match_cpu(card):
    from chameleon_recsys_tpu_torch.baselines.sr_gnn import SRGNN

    torch.backends.cuda.matmul.allow_tf32 = False
    batches = _neural_batches(500, 4)
    runs = []
    for device in ("cpu", card):
        model = SRGNN(500, hidden_size=24, seed=3, device=device)
        rng = np.random.RandomState(4)
        losses = [float(model.fit_batch(items, labels[:, 0], buf, n_sample=32, rng=rng))
                  for items, labels, buf in batches]
        runs.append((losses, model))
    (cpu_losses, cpu_model), (card_losses, card_model) = runs
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=NEURAL_CARD_TOL)
    _assert_params_match(card_model.params, cpu_model.params)


def test_device_time_helpers_on_card(card, tmp_path):
    """The timers and the trace readers see the card's work: a [512]^2
    matmul (one or more cuBLAS launches) then an in-place add, inside a
    ``record_function`` range whose device-side span is no launch."""
    from chameleon_recsys_tpu_torch.utils import profiling

    a = torch.randn(512, 512, device=card)

    def fn():
        with torch.profiler.record_function("helper_range"):
            return (a @ a).add_(1.0)

    times = profiling.device_call_times_ms(fn, (), 5)
    assert len(times) == 5 and all(t > 0 for t in times)
    assert profiling.device_time_ms(fn) > 0
    assert profiling.cuda_ms(fn, 5) > 0
    split = profiling.launch_split(fn, 3)
    assert len(split) >= 2 and all(us > 0 for _, us in split)
    assert "add" in split[-1][0]
    prof = profiling.device_profile(fn, 3)
    assert prof is not None and prof.launches == pytest.approx(len(split))
    assert not any("helper_range" in name for name, _ in split)
    assert not any("helper_range" in name for name, _, _ in prof.kernels)
    assert prof.busy_us == pytest.approx(sum(us for _, us in split), rel=0.5)
    with profiling.torch_trace(str(tmp_path)):
        fn()
        torch.cuda.synchronize()
    totals = profiling.device_op_totals(str(tmp_path))
    assert len(totals) >= 2 and all(ms > 0 for ms in totals.values())
    assert len(profiling.device_op_durations_by_track(str(tmp_path))) == 1


# ---------------------------------------------------------------------------
# multi-GPU on one card: the collectives the sharded steps use, and the
# sharded step at 1 x 1 over NCCL against the plain step
# ---------------------------------------------------------------------------


def test_gloo_collectives_take_cuda_tensors_two_ranks_on_one_card(card):
    from _torch_parallel_worker import card_collectives_rank, run_world

    ranks = run_world(card_collectives_rank, 2)
    for rank in ranks:
        assert rank["on_card"]
        np.testing.assert_array_equal(rank["sum"], np.full(5, 3.0))
        np.testing.assert_array_equal(np.stack(rank["gathered"]),
                                      [[0, 1, 2], [10, 11, 12]])


def test_sharded_step_at_1x1_over_nccl_is_the_plain_step(card):
    """One rank over NCCL: the sharded eval step's metrics, fetches and
    stream and the sharded train step's metrics and stream bit-equal to the
    plain steps' on the same weights and uniforms, with the same kernel
    launches (eval K1f 1, K2f 2; train K1fs 1, K1b 1, K2f 2, K2b 2); the
    gradients within f32 noise (the embeddings' backward adds with float
    atomics on the card, ROADMAP section 3.3)."""
    from _torch_parallel_worker import card_step_rank, run_world

    cfg, sess, art = _tiny_eval_world()
    cfg = dataclasses.replace(cfg, train_valid_row_capacity=48, negative_samples=5,
                              negative_sample_from_buffer=30)
    [out] = run_world(card_step_rank, 1, cfg, sess, art, backend="nccl")
    assert out["backend"] == "nccl"
    plain, sharded = out["plain"], out["sharded"]
    # [K1f, K1fs, K1b, K2f, K2b] per eval step, then per train step
    assert plain["launches"] == sharded["launches"] == [[1, 0, 0, 2, 0], [0, 1, 1, 2, 2]]
    for key in ("eval_metrics", "fetches", "eval_stream", "metrics", "stream"):
        assert plain[key].keys() == sharded[key].keys(), key
        for name, value in plain[key].items():
            np.testing.assert_array_equal(sharded[key][name], value, err_msg=f"{key} {name}")
    for name, g in plain["grads"].items():
        assert np.linalg.norm(sharded["grads"][name] - g) <= 1e-5 * np.linalg.norm(g) + 1e-7, name


# the quality example (cli/train_nar_synthetic.py) with both kernel flags
# against the same run without them, from the same weights and sampler
# uniforms: f32 sums in another order, which Adam's first moves (~lr times
# the sign of gradients that are 0 up to rounding) carry on over the steps,
# so each hour's loss at 1e-4 relative and the eval's HR and MRR at 2e-2
# (a few of ~450 ranked clicks across a near tie)
SYNTHETIC_LOSS_REL, SYNTHETIC_METRIC_ABS = 1e-4, 2e-2


def test_quality_example_kernels_match_the_plain_path(card, monkeypatch, tmp_path):
    """RESULTS.md A's size (800 items, 96 sessions an hour, CAR 128, UGRNN
    64 x 2, 20 negatives) over two hours (train 0, evaluate 1, train 1),
    both runs drawing their sampler uniforms from one numpy seed
    (``chip_smoke.seeded_uniforms``)."""
    from chameleon_recsys_tpu_torch.cli import train_nar_synthetic
    from chip_smoke import seeded_uniforms

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    argv = ["--hours", "2", "--eval_every", "1", "--sessions_per_hour", "96",
            "--num_items", "800"]
    args = train_nar_synthetic.create_args_parser().parse_args(argv)
    runs = {}
    for flags in (False, True):
        harness, source = train_nar_synthetic.build(
            args, "cuda", {"use_pallas_rnn": flags, "use_pallas_scorer": flags})
        losses = []
        train_hour = harness.train_hour
        harness.train_hour = lambda s: losses.append(train_hour(s)["avg_ce_loss"])
        with seeded_uniforms(3, harness.cfg):
            before = [cand_scorer.launches, cand_scorer.stash_launches,
                      cand_scorer.bwd_launches, ugrnn.launches, ugrnn.bwd_launches]
            rows = harness.run(source, range(args.hours))
            torch.cuda.synchronize()
        after = [cand_scorer.launches, cand_scorer.stash_launches, cand_scorer.bwd_launches,
                 ugrnn.launches, ugrnn.bwd_launches]
        runs[flags] = losses, rows, [a - b for a, b in zip(after, before)]
    assert all(n == 0 for n in runs[False][2])
    assert all(n > 0 for n in runs[True][2]), runs[True][2]
    (plain_losses, plain_rows, _), (losses, rows, _) = runs[False], runs[True]
    np.testing.assert_allclose(losses, plain_losses, rtol=SYNTHETIC_LOSS_REL)
    assert len(rows) == len(plain_rows) == 1
    for key in ("hitrate_at_n_chameleon", "mrr_at_n_chameleon"):
        assert rows[0][key] == pytest.approx(plain_rows[0][key], abs=SYNTHETIC_METRIC_ABS)
    assert rows[0]["hitrate_at_n_pop_recent"] == plain_rows[0]["hitrate_at_n_pop_recent"]


def test_directory_checkpoint_round_trip_on_card(card, monkeypatch, tmp_path):
    """The harness's directory checkpoint on the card (the example's harness
    at a small size, both kernel flags on): the state bit-equal after the
    load, the next hour against the pickle-resumed harness's (the
    embeddings' backward adds with float atomics: the loss and the
    parameters at 1e-5)."""
    from chameleon_recsys_tpu_torch.cli import train_nar_synthetic

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    args = train_nar_synthetic.create_args_parser().parse_args(
        ["--hours", "3", "--eval_every", "1", "--sessions_per_hour", "32",
         "--num_items", "200", "--car_size", "32", "--rnn_units", "16", "--batch_size", "8"])
    overrides = {"use_pallas_rnn": True, "use_pallas_scorer": True,
                 "matching_layer_sizes": (16, 8, 8)}
    h, source = train_nar_synthetic.build(args, "cuda", overrides)
    h.run(source, range(2))
    directory = h.save_checkpoint_dcp()
    pickled = h.save_checkpoint()
    by_dcp, by_pickle = (train_nar_synthetic.build(args, "cuda", overrides)[0]
                         for _ in range(2))
    by_dcp.init_state()
    by_dcp.load_checkpoint_dcp(directory)
    by_pickle.load_checkpoint(pickled)
    for (name, p), q in zip(h.state.model.named_parameters(), by_dcp.state.model.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(h.state.optimizer.state[p][k],
                               by_dcp.state.optimizer.state[q][k]), (name, k)
    for field, value in h.state.stream._asdict().items():
        assert torch.equal(getattr(by_dcp.state.stream, field), value), field
    assert torch.equal(h.state.generator.get_state(), by_dcp.state.generator.get_state())
    assert (by_dcp.hours_trained, by_dcp.evals_done, by_dcp.state.step) == (
        h.hours_trained, h.evals_done, h.state.step)
    a, b = by_dcp.train_hour(source(2)), by_pickle.train_hour(source(2))
    assert a["avg_ce_loss"] == pytest.approx(b["avg_ce_loss"], rel=1e-5)
    # but the matching output's bias: its gradient is 0 up to rounding (each
    # row's candidate gradients sum to 0), so Adam moves it by about lr on
    # the atomics' noise (ROADMAP section 3; read on an H100: 7.8e-4)
    for (name, p), q in zip(by_dcp.state.model.named_parameters(),
                            by_pickle.state.model.parameters()):
        if name != "matching_out_bias":
            assert (p - q).abs().max().item() <= 1e-5, name


# ---------------------------------------------------------------------------
# serving: the recommend call's scoring replayed as one CUDA graph a shape
# ---------------------------------------------------------------------------

GRAPH_SHAPES = ((32, 500, 10), (1, 64, 5))  # (sessions, candidates, top_k)


def _graph_server(card, dtype):
    """A small served model (bf16 or f32, the UGRNN on its kernel) over
    1,200 articles, its stream warmed by one batch, live sessions and two
    more batches to observe; candidates a row, three of them padding."""
    FeatureSpec = port.FeatureSpec
    n = 1200
    article_schema = port.ArticleFeaturesSchema(features=(
        FeatureSpec("article_id", "categorical", n),
        FeatureSpec("created_at_ts", "numerical", dtype="int"),
        FeatureSpec("category_id", "categorical", 12),
    ))
    session_schema = port.SessionFeaturesSchema(sequence=(
        FeatureSpec("event_timestamp", "numerical", dtype="int"),
        FeatureSpec("item_clicked", "categorical", n),
        FeatureSpec("device", "categorical", 5),
        FeatureSpec("hour_sin", "numerical", dtype="float"),
    ))
    cfg = port.NARConfig(
        car_embedding_size=32, rnn_units=24, rnn_num_layers=2,
        matching_layer_sizes=(16, 8, 8), recent_clicks_buffer_max_size=256,
        recent_clicks_for_normalization=128, batch_size=32, max_session_length=8,
        use_pallas_rnn=True, compute_dtype=dtype,
    )
    corpus = make_synthetic_corpus(article_schema, ace_dim=16)
    model = port.NARModel(cfg, session_schema, article_schema, 16)
    model.reset_parameters(torch.Generator().manual_seed(3))
    server = port.NARServer(
        cfg, session_schema, article_schema, model.state_dict(),
        init_stream_state(cfg, n, device=card), corpus.ace_matrix, corpus.metadata,
        device=card,
    )
    sessions = synthetic_hour_sessions(corpus, session_schema, 0, 96,
                                       cfg.max_session_length)
    server.observe(sessions[64:])
    rng = np.random.RandomState(5)
    cands = {}
    for b, c, _ in GRAPH_SHAPES:
        rows = np.stack([rng.choice(np.arange(1, n), c, replace=False) for _ in range(b)])
        rows[:, -3:] = 0
        cands[(b, c)] = rows.astype(np.int32)
    return cfg, server, sessions[:32], sessions[32:64], cands


def _eager(server, sessions, cand, top_k):
    """``_score`` run eagerly on the live stream, as the CPU runs it."""
    batch = {k: torch.from_numpy(v).to(server.device)
             for k, v in server._collate_serving(sessions).items()}
    ids, scores = server._score(batch, torch.from_numpy(cand).to(server.device), top_k,
                                server.stream.recent_pop_norm, server.stream.buffer_ids)
    return ids.cpu().numpy(), scores.cpu().numpy()


def _assert_same_answer(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], err_msg=what)
    np.testing.assert_array_equal(got[1], want[1], err_msg=what)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_recommend_replays_one_graph_per_request_shape(card, dtype):
    """Eager (first call), captured (second) and replayed (third) answers
    are the same bits; a replay counts the UGRNN kernel's launches as the
    eager call does; after ``observe`` the replay answers on the new stream;
    the profiler sees the kernel inside the replayed graph."""
    from chameleon_recsys_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, server, live, more, cands = _graph_server(card, dtype)
    was = profiling.set_tracing(True)
    profiling.reset_spans()
    try:
        for b, c, k in GRAPH_SHAPES:
            req, cand = live[:b], cands[(b, c)]
            outs, launches = [], []
            for _ in range(3):
                before = (ugrnn.launches, ugrnn.resident_launches)
                outs.append(server.recommend(req, candidates=cand, top_k=k))
                launches.append((ugrnn.launches - before[0],
                                 ugrnn.resident_launches - before[1]))
            assert launches == [(cfg.rnn_num_layers, cfg.rnn_num_layers)] * 3, launches
            assert outs[0][0].shape == (b, k) and np.isfinite(outs[0][1]).all()
            assert not np.isin(outs[0][0], 0).any()  # padding scores -inf
            _assert_same_answer(outs[1], outs[0], f"captured against eager at {(b, c, k)}")
            _assert_same_answer(outs[2], outs[0], f"replayed against eager at {(b, c, k)}")
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
    assert list(server.graphs.graphs) == list(GRAPH_SHAPES)
    assert spans["nar.serve.score"][1] == 3 * len(GRAPH_SHAPES)
    assert spans["nar.serve.capture"][1] == spans["nar.serve.replay"][1] == len(GRAPH_SHAPES)

    # observe replaces the stream's tensors: the replay reads the new ones
    b, c, k = GRAPH_SHAPES[0]
    req, cand = live[:b], cands[(b, c)]
    stale = server.recommend(req, candidates=cand, top_k=k)
    server.observe(more)
    fresh = server.recommend(req, candidates=cand, top_k=k)
    assert not np.array_equal(fresh[1], stale[1]), "the new stream changes no score"
    _assert_same_answer(fresh, _eager(server, req, cand, k), "replayed after observe")

    # the profiler sees the kernel's launches inside the replayed graph
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        server.recommend(req, candidates=cand, top_k=k)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("ugrnn_fwd" in n for n in names) == cfg.rnn_num_layers, names
    assert len(server.graphs.graphs) == len(GRAPH_SHAPES)


def test_score_graphs_hold_at_most_their_capacity(card):
    """A key seen once never captures; a new capture past the capacity
    evicts the least recently replayed key, which captures again when it
    is seen twice more."""
    _, server, live, _, cands = _graph_server(card, "bfloat16")
    server.graphs.capacity = 2
    cand = cands[(32, 500)]

    def call(b, k):
        return server.recommend(live[:b], candidates=cand[:b], top_k=k)

    call(32, 10)
    assert not server.graphs.graphs  # seen once: eager
    for b in (32, 16, 16):
        call(b, 10)
    assert list(server.graphs.graphs) == [(32, 500, 10), (16, 500, 10)]
    call(32, 10)  # replayed: now the most recent
    call(8, 10)
    call(8, 10)
    assert list(server.graphs.graphs) == [(32, 500, 10), (8, 500, 10)]
    call(16, 10)
    assert (16, 500, 10) not in server.graphs.graphs
    want = _eager(server, live[:16], cand[:16], 10)
    _assert_same_answer(call(16, 10), want, "captured again after eviction")
    assert list(server.graphs.graphs) == [(8, 500, 10), (16, 500, 10)]


# ---------------------------------------------------------------------------
# eval: the eval step replayed as one CUDA graph a batch shape
# ---------------------------------------------------------------------------

EVAL_BATCHES = 5  # an hour: warm-up, capture, three replays


def _eval_graph_harness(card, dtype, model_dir):
    """A small harness on the card (the tiny eval world, the UGRNN and the
    fused scorer on their kernels) after one train hour; its eval hours
    hold ``EVAL_BATCHES`` batches."""
    from chameleon_recsys_tpu_torch.config import RunConfig
    from chameleon_recsys_tpu_torch.train.temporal import TemporalHarness

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sess, art = _tiny_eval_world()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, negative_samples=5,
                              negative_sample_from_buffer=30)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    n = EVAL_BATCHES * cfg.batch_size

    def source(hour):
        return synthetic_hour_sessions(corpus, sess, hour, n, cfg.max_session_length)

    harness = TemporalHarness(cfg, RunConfig(model_dir=str(model_dir), random_seed=5), sess, art,
                              corpus.ace_matrix, corpus.metadata, device=card)
    harness.train_hour(source(0))
    return cfg, harness, source


def _recorded_hour(harness, sessions, monkeypatch):
    """An eval hour, with each eval step's returns and launches: (row,
    [(returns, their copies to the host at return, launches)])."""
    from chameleon_recsys_tpu_torch.ops.kernels import launch_counts
    from chameleon_recsys_tpu_torch.train import temporal

    calls = []
    original = temporal.eval_step

    def recording(*a, **k):
        before = launch_counts()
        out = original(*a, **k)
        after = launch_counts()
        host = tuple({n: t.cpu() for n, t in part.items()} for part in
                     (out[0]._asdict(), out[1], out[2]))
        calls.append((out, host, {n: after[n] - before[n] for n in after
                                  if after[n] != before[n]}))
        return out

    monkeypatch.setattr(temporal, "eval_step", recording)
    row = harness.evaluate_hour(sessions)
    monkeypatch.setattr(temporal, "eval_step", original)
    return row, calls


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_eval_hour_replays_one_graph_per_batch_shape(card, dtype, monkeypatch, tmp_path):
    """One eval hour graphed and one eager, from the same state and
    generator state: the same negatives, ranking, probabilities and stream
    after every batch, the same HR and MRR, the same generator state after
    the hour and the pre-hour stream restored; tensors a call returned are
    unchanged by later replays; one capture for the hour's one key; every
    call counts the scorer's and the UGRNN's launches."""
    from chameleon_recsys_tpu_torch.utils import profiling

    cfg, harness, source = _eval_graph_harness(card, dtype, tmp_path)
    harness.fetch_full_ranking = True  # the probabilities too
    sessions = source(1)
    before = {n: t.clone() for n, t in harness.state.stream._asdict().items()}
    generator = harness.state.generator.get_state()
    graphs = harness._eval_graphs
    assert graphs is not None and not graphs.graphs

    was = profiling.set_tracing(True)
    profiling.reset_spans()
    try:
        graphed_row, graphed = _recorded_hour(harness, sessions, monkeypatch)
        torch.cuda.synchronize()
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
    graphed_generator = harness.state.generator.get_state()
    for name, value in before.items():
        assert torch.equal(getattr(harness.state.stream, name), value), name
    assert len(graphed) == EVAL_BATCHES
    assert spans["nar.eval.dispatch"][1] == EVAL_BATCHES
    assert spans["nar.eval.capture"][1] == 1
    assert spans["nar.eval.replay"][1] == EVAL_BATCHES - 2
    assert len(graphs.graphs) == 1 and not graphs.seen
    want = {"cand_score_fwd": 1, "ugrnn_fwd": cfg.rnn_num_layers}
    for i, (_, _, launched) in enumerate(graphed):
        assert {n: launched.get(n) for n in want} == want, (i, launched)
    # what a call returned is its own: later replays leave it as it was
    for i, (out, host, _) in enumerate(graphed):
        for part, copies in zip((out[0]._asdict(), out[1], out[2]), host):
            for name, tensor in part.items():
                assert torch.equal(tensor.cpu(), copies[name]), (i, name)

    harness._eval_graphs = None  # the eager step, from the same state
    harness.state.generator.set_state(generator)
    eager_row, eager = _recorded_hour(harness, sessions, monkeypatch)
    assert torch.equal(harness.state.generator.get_state(), graphed_generator)
    for name, value in before.items():
        assert torch.equal(getattr(harness.state.stream, name), value), name
    for i, ((_, got, _), (_, ref, _)) in enumerate(zip(graphed, eager)):
        for part_got, part_ref in zip(got, ref):
            assert list(part_got) == list(part_ref), i
            for name, value in part_ref.items():
                assert torch.equal(part_got[name], value), (i, name)
    for key in ("hitrate_at_n", "mrr_at_n", "clicks_count", "sessions_count"):
        assert graphed_row[key] == eager_row[key], key
    assert eager_row["clicks_count"] > 0


def test_eval_graphs_recapture_for_another_model(card, tmp_path):
    """A graph holds the addresses of the parameters it read: a harness
    whose model is built again drops its graphs and captures anew, with
    the eager step's answers."""
    cfg, harness, source = _eval_graph_harness(card, "bfloat16", tmp_path)
    harness.evaluate_hour(source(1))
    graphs = harness._eval_graphs
    assert len(graphs.graphs) == 1
    held = next(iter(graphs.graphs.values()))
    old_model = harness.state.model  # alive: the new one takes other addresses
    harness.init_state()
    harness.train_hour(source(0))
    generator = harness.state.generator.get_state()
    graphed = harness.evaluate_hour(source(2))
    assert len(graphs.graphs) == 1 and next(iter(graphs.graphs.values())) is not held
    harness._eval_graphs = None
    harness.state.generator.set_state(generator)
    eager = harness.evaluate_hour(source(2))
    assert (graphed["hitrate_at_n"], graphed["mrr_at_n"]) == (eager["hitrate_at_n"],
                                                                eager["mrr_at_n"])
    assert old_model is not harness.state.model


def test_staged_batches_reach_the_card_as_collated(card, tmp_path):
    """The harness's pinned staging: each put gives the collated arrays on
    the card, also where a staging set comes round again while the card
    has not yet read the batches put earlier."""
    cfg, harness, source = _eval_graph_harness(card, "bfloat16", tmp_path)
    batches = list(harness._batches(source(3)))
    torch.cuda._sleep(50_000_000)  # keep the stream busy while the puts queue
    put = [harness._put_batch(b) for b in batches]
    for np_batch, batch in zip(batches, put):
        assert list(batch) == list(np_batch)
        for name, values in np_batch.items():
            assert batch[name].is_cuda
            np.testing.assert_array_equal(batch[name].cpu().numpy(), values, err_msg=name)


def _folding_harness(card, model_dir):
    """``_eval_graph_harness``'s harness with HitRateBySessionPosition on
    and the eval step folding the metric set by position too."""
    from chameleon_recsys_tpu_torch.metrics.device import MetricFold

    cfg, harness, source = _eval_graph_harness(card, "bfloat16", model_dir)
    assert harness._metric_fold is not None  # on the card the step folds
    harness.eval_metrics_by_session_position = True
    harness._metric_fold = MetricFold(cfg.metrics_top_n, cfg.eval_negative_sample_relevance,
                                      True)
    return cfg, harness, source


def test_graphed_hour_folds_the_metric_set_as_the_host_suite(card, tmp_path):
    """A graphed eval hour whose step folds CHAMELEON's metric set and the
    same hour on the host suite, from the same state and generator state:
    the same row under ``test_torch_device_metrics.py``'s tolerances, HR
    equal to the step's ``hitrate_at_n``; the fold's span a batch, and
    the graph replayed."""
    from test_torch_device_metrics import _assert_rows_agree

    from chameleon_recsys_tpu_torch.utils import profiling

    cfg, harness, source = _folding_harness(card, tmp_path)
    sessions = source(1)
    generator = harness.state.generator.get_state()
    was = profiling.set_tracing(True)
    profiling.reset_spans()
    try:
        folded = harness.evaluate_hour(sessions)
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
    assert spans["nar.eval.metrics.device"][1] == spans["nar.eval.metrics"][1] == EVAL_BATCHES
    assert spans["nar.eval.replay"][1] == EVAL_BATCHES - 2
    harness._metric_fold = None  # the host suite, from the same state
    harness.state.generator.set_state(generator)
    host = harness.evaluate_hour(sessions)
    _assert_rows_agree(folded, host)
    assert folded["hitrate_at_n"] == folded["hitrate_at_n_chameleon"]
    assert folded["clicks_count"] > 0
    assert any(k.startswith("clicks_at_pos_chameleon_") for k in folded)


def test_folded_eval_hours_are_bit_identical(card, tmp_path):
    """The same eval hour twice from the same state, the first warming up
    and capturing, the second all replays of the same graph (the fold's
    bitmaps stay where they are): one capture, and bit-identical rows."""
    from chameleon_recsys_tpu_torch.utils import profiling

    cfg, harness, source = _folding_harness(card, tmp_path)
    sessions = source(1)
    generator = harness.state.generator.get_state()
    was = profiling.set_tracing(True)
    profiling.reset_spans()
    try:
        first = harness.evaluate_hour(sessions)
        held = list(harness._eval_graphs.graphs.values())
        harness.state.generator.set_state(generator)
        second = harness.evaluate_hour(sessions)
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
    assert len(held) == 1 and list(harness._eval_graphs.graphs.values()) == held
    assert spans["nar.eval.capture"][1] == 1
    assert spans["nar.eval.replay"][1] == 2 * EVAL_BATCHES - 2
    assert list(first) == list(second)
    for key, value in first.items():
        if not key.endswith(("elapsed_s", "per_s")):
            assert repr(second[key]) == repr(value), key


# ---------------------------------------------------------------------------
# train: the train step replayed as one CUDA graph a batch shape
# ---------------------------------------------------------------------------

# chip_smoke.py's RESUME_TOL: a train hour from the same state differs by the
# embeddings' backward, which adds with float atomics (the losses relative,
# the parameters absolute)
TRAIN_RESUME_TOL = {"loss": 1e-5, "param": 1e-5}


def _train_graph_harness(card, model_dir, dtype="bfloat16", capacity=48):
    """``_eval_graph_harness``'s world with a row capacity (or the grid
    sampler without one), after one train hour; its hours hold
    ``EVAL_BATCHES`` batches."""
    from chameleon_recsys_tpu_torch.config import RunConfig
    from chameleon_recsys_tpu_torch.train.temporal import TemporalHarness

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, sess, art = _tiny_eval_world()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, negative_samples=5,
                              negative_sample_from_buffer=30,
                              train_valid_row_capacity=capacity)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    n = EVAL_BATCHES * cfg.batch_size

    def source(hour):
        return synthetic_hour_sessions(corpus, sess, hour, n, cfg.max_session_length)

    harness = TemporalHarness(cfg, RunConfig(model_dir=str(model_dir), random_seed=5), sess, art,
                              corpus.ace_matrix, corpus.metadata, device=card)
    harness.train_hour(source(0))
    return cfg, harness, source


def _recorded_train_hour(harness, sessions, monkeypatch):
    """A train hour, with each train step's returns, their copies to the
    host at return, the negatives it scored (read from the step's own
    tensor: in a replay the graph's, which holds the replay's negatives)
    and its launches: (hour's stats, [(returns, copies, negatives,
    launches)])."""
    from chameleon_recsys_tpu_torch.ops.kernels import launch_counts
    from chameleon_recsys_tpu_torch.train import steps, temporal

    calls, scored = [], {}
    original_inputs, original_step = steps._train_inputs, temporal.train_step

    def inputs(*a, **k):
        out = original_inputs(*a, **k)
        scored["neg_ids"] = out.neg_ids  # a capture's is the graph's own tensor
        return out

    def recording(*a, **k):
        before = launch_counts()
        state, metrics = original_step(*a, **k)
        after = launch_counts()
        out = (state.stream._asdict(), metrics)
        host = tuple({n: t.cpu() for n, t in part.items()} for part in out)
        calls.append((out, host, scored["neg_ids"].clone(),
                      {n: after[n] - before[n] for n in after if after[n] != before[n]}))
        return state, metrics

    monkeypatch.setattr(steps, "_train_inputs", inputs)
    monkeypatch.setattr(temporal, "train_step", recording)
    try:
        stats = harness.train_hour(sessions)
    finally:
        monkeypatch.setattr(steps, "_train_inputs", original_inputs)
        monkeypatch.setattr(temporal, "train_step", original_step)
    return stats, calls


def _traced(fn):
    """``fn()`` with tracing on: (its answer, the spans it opened)."""
    from chameleon_recsys_tpu_torch.utils import profiling

    was = profiling.set_tracing(True)
    profiling.reset_spans()
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()


@pytest.mark.parametrize("dtype, capacity", [("bfloat16", 48), ("float32", None)])
def test_train_hour_replays_one_graph_per_batch_shape(card, dtype, capacity, monkeypatch,
                                                      tmp_path):
    """One train hour graphed and one eager, from the same state and
    generator state: the same negatives and stream after every batch, and
    the same generator state after the hour; the losses and the parameters
    within chip_smoke.py's RESUME_TOL (the embeddings' backward adds with
    float atomics), but the matching output's bias, whose gradient is 0 up
    to rounding (``test_directory_checkpoint_round_trip_on_card``); one
    capture for the hour's one key; every call counts the scorer's and the
    UGRNN's forward and backward launches; what a call returned is
    unchanged by later replays."""
    cfg, harness, source = _train_graph_harness(card, tmp_path, dtype, capacity)
    graphs = harness._train_graphs
    assert graphs is not None and len(graphs.graphs) == 1  # the first hour's
    path = harness.save_checkpoint()
    graphs.clear()  # this hour warms up and captures again
    sessions = source(1)
    (graphed_stats, graphed), spans = _traced(
        lambda: _recorded_train_hour(harness, sessions, monkeypatch))
    graphed_generator = harness.state.generator.get_state()
    graphed_params = {n: p.detach().clone() for n, p in harness.state.model.named_parameters()}
    assert len(graphed) == EVAL_BATCHES
    assert spans["nar.train_step"][1] == EVAL_BATCHES
    assert spans["nar.train_step.capture"][1] == 1
    assert spans["nar.train_step.replay"][1] == EVAL_BATCHES - 2
    assert spans["nar.train_step.forward"][1] == 2  # the warm-up's and the capture's
    assert len(graphs.graphs) == 1 and not graphs.seen
    first = graphed[0][3]  # the warm-up's, eager
    assert first.get("cand_score_fwd_stash") == 1 and first.get("cand_score_bwd", 0) > 0
    assert first.get("ugrnn_fwd") == cfg.rnn_num_layers and first.get("ugrnn_bwd", 0) > 0
    for i, (_, _, _, launched) in enumerate(graphed):
        assert launched == first, (i, launched)
    for i, (out, host, _, _) in enumerate(graphed):
        for part, copies in zip(out, host):
            for name, tensor in part.items():
                assert torch.equal(tensor.cpu(), copies[name]), (i, name)

    harness._train_graphs = None  # the eager step, from the same state
    harness.load_checkpoint(path)
    eager_stats, eager = _recorded_train_hour(harness, sessions, monkeypatch)
    assert torch.equal(harness.state.generator.get_state(), graphed_generator)
    for i, ((out, _, negs, _), (ref, _, ref_negs, _)) in enumerate(zip(graphed, eager)):
        assert torch.equal(negs, ref_negs), i
        for name, value in ref[0].items():
            assert torch.equal(out[0][name], value), (i, name)
        assert list(out[1]) == list(ref[1])
        loss, ref_loss = float(out[1]["ce_loss"]), float(ref[1]["ce_loss"])
        assert abs(loss - ref_loss) <= TRAIN_RESUME_TOL["loss"] * abs(ref_loss), i
    assert graphed_stats["avg_ce_loss"] == pytest.approx(eager_stats["avg_ce_loss"],
                                                         rel=TRAIN_RESUME_TOL["loss"])
    for name, p in harness.state.model.named_parameters():
        if name != "matching_out_bias":
            diff = (p - graphed_params[name]).abs().max().item()
            assert diff <= TRAIN_RESUME_TOL["param"], (name, diff)


def test_a_hooked_model_trains_eagerly(card, tmp_path):
    """A replay runs no Python hook: with a forward hook on the model every
    train step runs eagerly and the hook sees each; once it is removed the
    next hour replays the graph the first hour captured, and the
    parameters' gradients are the graph's again."""
    cfg, harness, source = _train_graph_harness(card, tmp_path)
    graph = next(iter(harness._train_graphs.graphs.values()))
    seen = []
    hook = harness.state.model.register_forward_hook(lambda *a: seen.append(1))
    _, spans = _traced(lambda: harness.train_hour(source(1)))
    hook.remove()
    assert len(seen) == spans["nar.train_step"][1] == EVAL_BATCHES
    assert "nar.train_step.capture" not in spans and "nar.train_step.replay" not in spans
    params = list(harness.state.model.parameters())
    assert not any(p.grad is g for p, g in zip(params, graph.grads))  # the eager steps'
    _, spans = _traced(lambda: harness.train_hour(source(2)))
    assert spans["nar.train_step.replay"][1] == EVAL_BATCHES
    assert list(harness._train_graphs.graphs.values()) == [graph]
    assert all(p.grad is g for p, g in zip(params, graph.grads))


def test_train_graphs_recapture_after_a_load_and_the_eval_graph_holds(card, tmp_path):
    """Adam updates the parameters in place, so the eval graph is held
    across train hours, and the train graph across eval hours; a
    ``load_checkpoint`` replaces Adam's state, so the next train hour warms
    up and captures anew, with the eager hour's negatives and stream."""
    cfg, harness, source = _train_graph_harness(card, tmp_path)
    path = harness.save_checkpoint()
    train_graph = next(iter(harness._train_graphs.graphs.values()))
    harness.evaluate_hour(source(1))
    eval_graph = next(iter(harness._eval_graphs.graphs.values()))
    (_, spans) = _traced(lambda: (harness.train_hour(source(1)),
                                  harness.evaluate_hour(source(2))))
    assert spans["nar.train_step.replay"][1] == EVAL_BATCHES
    assert spans["nar.eval.replay"][1] == EVAL_BATCHES
    assert "nar.train_step.capture" not in spans and "nar.eval.capture" not in spans
    assert list(harness._train_graphs.graphs.values()) == [train_graph]
    assert list(harness._eval_graphs.graphs.values()) == [eval_graph]

    harness.load_checkpoint(path)
    generator = harness.state.generator.get_state()
    graphed, spans = _traced(lambda: harness.train_hour(source(1)))
    assert spans["nar.train_step.capture"][1] == 1
    assert spans["nar.train_step.replay"][1] == EVAL_BATCHES - 2
    assert next(iter(harness._train_graphs.graphs.values())) is not train_graph
    stream = {n: t.clone() for n, t in harness.state.stream._asdict().items()}
    harness._train_graphs = None
    harness.load_checkpoint(path)
    assert torch.equal(harness.state.generator.get_state(), generator)
    eager = harness.train_hour(source(1))
    for name, value in stream.items():
        assert torch.equal(getattr(harness.state.stream, name), value), name
    assert graphed["avg_ce_loss"] == pytest.approx(eager["avg_ce_loss"],
                                                   rel=TRAIN_RESUME_TOL["loss"])


def test_eval_and_train_steps_do_not_sync(card):
    """One eval step, folding the metric set, and one eager train step,
    each after one to warm up, and a graphed train step's replay, after its
    warm-up and capture, raise nothing with the CUDA sync debug mode at
    "error": no host sync is left in either step (a graph's capture could
    not hold one) nor in the replay's copies and draws."""
    from chameleon_recsys_tpu_torch.metrics.device import MetricFold
    from chameleon_recsys_tpu_torch.train.train_graphs import TrainGraphs

    cfg, sess, art = _tiny_eval_world()
    cfg = dataclasses.replace(cfg, train_valid_row_capacity=48, negative_samples=5,
                              negative_sample_from_buffer=30)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    b, length = cfg.batch_size, cfg.max_session_length
    batches = [{k: torch.from_numpy(v).to(card) for k, v in collate_sessions(
        synthetic_hour_sessions(corpus, sess, h, b, length), sess, b, length).items()}
        for h in range(3)]
    ace = torch.from_numpy(corpus.ace_matrix).to(card)
    metadata = {k: torch.from_numpy(np.asarray(v)).to(card)
                for k, v in corpus.metadata.items()}
    model = port.NARModel(cfg, sess, art, 8)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(card)
    stream = update_stream_state(init_stream_state(cfg, 200, device=card),
                                 *_batch_all_clicks(batches[0]), cfg)
    state = init_train_state(model, stream, torch.Generator(device=card).manual_seed(1))
    fold = MetricFold(cfg.metrics_top_n, cfg.eval_negative_sample_relevance, True)
    graphs = TrainGraphs()
    torch.cuda.synchronize()
    # the graphed step warms up and captures under "default", replays under "error"
    for mode in ("default", "default", "error"):
        step = int(state.stream.current_step)
        torch.cuda.set_sync_debug_mode(mode)
        try:
            fold.seed_coverage(state.stream.buffer_ids, 200)
            new_stream, _, fetches = eval_step(model, state.stream, batches[1], ace, metadata,
                                               generator=state.generator, fold=fold)
            state, _ = train_step(state, batches[2], ace, metadata)
            state, _ = train_step(state, batches[2], ace, metadata, graphs=graphs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert int(new_stream.current_step) == step + 1
        assert int(state.stream.current_step) == step + 2
        assert fetches["metric_sums"].dtype == torch.float64
    assert len(graphs.graphs) == 1 and not graphs.seen
