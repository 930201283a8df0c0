"""The split-TF32 arithmetic of the fused scorer's float32 kernels, on the CPU.

On the card the f32 forward (``csrc/cand_score_fwd.cu``, namespace ``f32``)
and the f32 backward (its row kernel's two products on WMMA, its three C-wide
products on the TF32 core of ``csrc/sm90_gemm.cuh``) take every product
``a b`` as three TF32 products: with ``hi = rna_tf32(x)`` and ``lo =
rna_tf32(x - hi)`` of each operand, ``lo_a hi_b + hi_a lo_b + hi_a hi_b``.
This file emulates ``cvt.rna.tf32.f32`` with numpy (round to nearest, ties
away from zero, 10 mantissa bits kept) and drives the forward's CAR product
and first matching layer, and the backward's five products (a1, dprod, dW1,
dpre, dcar_w), through it at B's widths (C 1,024, matching 128/64/32, 300
rows), seeded inputs made with numpy.  Each TF32 product is exact in
float64, so the emulation sums each in float64 and rounds it to f32: it
models the split, not the card's order of summation (the tensor cores round
their sums toward zero; the kernels keep those chains short, see the
sources).

Against the JAX package's f32 ``cand_score_reference`` (its scores, the CAR
output computed as it computes it, and its gradients by ``jax.vjp``) the
three products stay within the card checks' f32 tolerances (``chip_smoke.py``:
nc 1e-5 absolute; scores and the 12 gradients 2e-4 normwise, with at most a
share 1e-4 of the elements off by more than 2e-4 of the largest); a single
TF32 product (hi hi) does not, which is why the kernels issue three.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.ops.pallas.cand_scorer import cand_score_reference as jax_reference

from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer

BT, K, C, M1, M2, M3 = 6, 50, 1024, 128, 64, 32
ALPHA = 0.2
NC_TOL, TOL, OUTLIERS = 1e-5, 2e-4, 1e-4
GRADS = ("di", "du", "dp", "dcar_w", "dcar_b", "dw1", "db1", "dw2", "db2", "dw3",
         "db3", "dw4")


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, ties away from
    zero (add half of the 13 dropped bits' range to the magnitude, drop them)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a, b):
    """a @ b as the kernels take it: lo hi + hi lo + hi hi, in that order."""
    (ah, al), (bh, bl) = split(a), split(b)
    f64 = lambda x, y: (x.astype(np.float64) @ y.astype(np.float64)).astype(np.float32)
    return (f64(al, bh) + f64(ah, bl)) + f64(ah, bh)


def mm1(a, b):
    """a @ b on one TF32 product (hi hi)."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    return (ah.astype(np.float64) @ bh.astype(np.float64)).astype(np.float32)


def f32mm(a, b):
    """a product the kernels keep on the CUDA cores (the matching tail)."""
    return (np.asarray(a, np.float64) @ np.asarray(b, np.float64)).astype(np.float32)


def leaky(x):
    return np.where(x > 0, x, np.float32(ALPHA) * x).astype(np.float32)


def dleaky(x):
    return np.where(x > 0, np.float32(1), np.float32(ALPHA))


def operands(seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    return [
        mk(BT * K, C, scale=0.5), mk(BT, C, scale=0.5), mk(BT, C, scale=0.5),
        mk(C, C, scale=C ** -0.5), mk(C, scale=0.1),
        mk(C, M1, scale=(2 / C) ** 0.5), mk(M1, scale=0.1),
        mk(M1, M2, scale=(2 / M1) ** 0.5), mk(M2, scale=0.1),
        mk(M2, M3, scale=(2 / M2) ** 0.5), mk(M3, scale=0.1),
        mk(M3, scale=M3 ** -0.5),
    ]


def forward(ops, mm):
    """The f32 forward with its two C-deep products taken by ``mm``: scores
    [N] and nc [N, C] (csrc/cand_score_fwd.cu, namespace f32)."""
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4 = ops
    rep = lambda x: np.repeat(x, K, axis=0)
    pre = leaky(i_rows + rep(u))
    nc = np.tanh(mm(pre, car_w) + car_b).astype(np.float32)
    x1 = leaky(mm(nc * rep(pred), w1) + b1)
    x2 = leaky(f32mm(x1, w2) + b2)
    x3 = leaky(f32mm(x2, w3) + b3)
    return (x3 * w4).sum(-1, dtype=np.float32), nc


def backward(ops, nc, g, mm):
    """The f32 backward on the stashed nc, its five tensor-core products
    taken by ``mm`` (``cand_scorer.cand_score_bwd_reference``, line by line)."""
    i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4 = ops
    rep = lambda x: np.repeat(x, K, axis=0)
    seg = lambda x: x.reshape(BT, K, -1).sum(1, dtype=np.float32)
    a0 = i_rows + rep(u)
    pre = leaky(a0)
    prod = nc * rep(pred)
    a1 = mm(prod, w1) + b1
    x1 = leaky(a1)
    a2 = f32mm(x1, w2) + b2
    x2 = leaky(a2)
    a3 = f32mm(x2, w3) + b3
    x3 = leaky(a3)
    ds = g.reshape(-1, 1)
    da3 = ds * w4 * dleaky(a3)
    da2 = f32mm(da3, w3.T) * dleaky(a2)
    da1 = f32mm(da2, w2.T) * dleaky(a1)
    dprod = mm(da1, w1.T)
    dncp = dprod * rep(pred) * (1 - nc * nc)
    dpre = mm(dncp, car_w.T)
    di = dpre * dleaky(a0)
    return (di, seg(di), seg(dprod * nc), mm(pre.T, dncp), dncp.sum(0), mm(prod.T, da1),
            da1.sum(0), f32mm(x1.T, da2), da2.sum(0), f32mm(x2.T, da3), da3.sum(0),
            (x3 * ds).sum(0))


@pytest.fixture(scope="module")
def reference():
    """The JAX package's f32 scores, CAR output and 12 gradients."""
    ops = operands()
    g = np.random.RandomState(1).standard_normal((BT, K)).astype(np.float32)
    jops = [jnp.asarray(t) for t in ops]
    scores, vjp = jax.vjp(lambda *a: jax_reference(*a, alpha=ALPHA), *jops)
    pre = jnp.where(jops[0] + jnp.repeat(jops[1], K, 0) > 0,
                    jops[0] + jnp.repeat(jops[1], K, 0),
                    ALPHA * (jops[0] + jnp.repeat(jops[1], K, 0)))
    nc = jnp.tanh(jnp.dot(pre, jops[3], precision="highest") + jops[4])
    grads = vjp(jnp.asarray(g))
    return ops, g, np.asarray(scores).reshape(-1), np.asarray(nc), [np.asarray(x) for x in grads]


def normwise(got, want):
    """(normwise error, share of elements off by more than TOL max|want|)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    norm = float(np.linalg.norm(diff) / max(np.linalg.norm(want), 1e-30))
    off = float((diff > TOL * max(np.abs(want).max(), 1e-30)).mean())
    return norm, off


def test_tf32_rna_rounds_to_nearest_ties_away():
    one_ulp = np.float32(2.0 ** -10)  # of 1.0 in TF32
    x = np.array([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2 ** -20,
                  3.14159265], np.float32)
    got = tf32_rna(x)
    assert got[0] == 1.0
    assert got[1] == np.float32(1.0 + one_ulp) and got[2] == -np.float32(1.0 + one_ulp)
    assert got[3] == 1.0
    assert (got.view(np.uint32) & 0x1FFF == 0).all() and abs(got[4] - 3.14159265) < 2e-3
    hi, lo = split(x)
    assert (np.abs(hi.astype(np.float64) + lo - x) <= 2.0 ** -21 * np.abs(x)).all()


def test_three_tf32_products_stay_within_the_card_tolerances(reference):
    ops, g, scores, nc, grads = reference
    got_scores, got_nc = forward(ops, mm3)
    assert np.abs(got_nc - nc).max() <= NC_TOL
    assert np.abs(got_scores - scores).max() <= NC_TOL
    assert normwise(got_scores, scores)[0] <= TOL
    for name, got, want in zip(GRADS, backward(ops, nc, g, mm3), grads):
        norm, off = normwise(got, want)
        assert norm <= TOL and off <= OUTLIERS, (name, norm, off)


def test_one_tf32_product_does_not(reference):
    ops, g, scores, nc, grads = reference
    got_scores, got_nc = forward(ops, mm1)
    assert np.abs(got_nc - nc).max() > 10 * NC_TOL
    worst = max(normwise(got, want)[0]
                for got, want in zip(backward(ops, nc, g, mm1), grads))
    assert worst > TOL


def test_the_emulated_kernels_match_the_ports_twins(reference):
    """The emulated forward and backward (three products) against the port's
    own plain twins on the same operands, which the card checks compare the
    kernels with: the same function, within the same tolerances."""
    ops, g, _, _, _ = reference
    tops = [torch.from_numpy(t) for t in ops]
    scores, nc = cand_scorer.cand_score_reference(*tops, alpha=ALPHA, return_nc=True)
    got_scores, got_nc = forward(ops, mm3)
    assert np.abs(got_nc - nc.numpy()).max() <= NC_TOL
    assert np.abs(got_scores - scores.numpy().reshape(-1)).max() <= NC_TOL
    twin = cand_scorer.cand_score_bwd_reference(*tops, nc, torch.from_numpy(g), alpha=ALPHA)
    for name, got, want in zip(GRADS, backward(ops, nc.numpy(), g, mm3), twin):
        norm, off = normwise(got, want.numpy())
        assert norm <= TOL and off <= OUTLIERS, (name, norm, off)
