"""The port's fused candidate scorer (plain twin and CPU wrapper) against the
JAX package's ``cand_score_pallas`` (interpret mode) and
``cand_score_reference``, on the same numpy inputs as
``tests/test_cand_scorer.py``.

Tolerances: float32 at 1e-5 (the same f32 arithmetic summed in another
order).  bfloat16 at 2e-2, the bf16 tolerance of ``tests/test_cand_scorer.py``:
the twin rounds as the Pallas kernel does, but a value that lands next to a
bf16 rounding boundary may round the other way after an f32 sum in another
order; against the JAX reference, which adds ``i + u`` in bf16, the roundings
differ by construction.  The Pallas kernel needs BT to be a multiple of its
8-row tile, so an odd BT is held against the JAX reference only.

The backward twin ``cand_score_bwd_reference`` is held against ``jax.vjp``
of ``cand_score_pallas`` (interpret mode; its forward stashes nc, its
backward is the stash body) at the tolerances of ``tests/test_cand_scorer.py``:
f32 gradients at 2e-4, bf16 at 2e-2.  The stashed ``nc`` agrees with JAX's
to one rounding, not bit for bit: XLA's f32 tanh and its summation order of
the CAR product are not torch's (in f32 most elements differ in the last
bit, 1e-6), so in bf16 a value next to a rounding boundary may round the
other way (one bf16 step, 4e-3 below 1.0, in at most 0.1% of the
elements; 1 in 19,200 here).  The odd shape is held against ``jax.vjp`` of the plain JAX
reference, in f32.  ``CandScore`` is held against autograd through the
forward twin, in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.ops.pallas import cand_scorer as jax_cand_scorer
from chameleon_recsys_tpu.ops.pallas.cand_scorer import (
    cand_score_pallas,
    cand_score_reference as jax_cand_score_reference,
)

from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def make_inputs(bt=16, k=6, c=64, m1=32, m2=16, m3=8, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32) * 0.3
    return dict(
        i_rows=mk(bt * k, c), u_pre=mk(bt, c), pred=mk(bt, c),
        car_w=mk(c, c) * 0.1, car_b=mk(c), w1=mk(c, m1) * 0.2, b1=mk(m1),
        w2=mk(m1, m2), b2=mk(m2), w3=mk(m2, m3), b3=mk(m3), w4=mk(m3),
    )


def as_jax(inputs, dtype):
    return [jnp.asarray(v, dtype) for v in inputs.values()]


def as_torch(inputs, dtype):
    # through f32 numpy: the same bf16 rounding (to nearest even) on both sides
    return [torch.from_numpy(v).to(dtype) for v in inputs.values()]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [dict(bt=16, k=6), dict(bt=8, k=50, c=48)])
def test_twin_matches_pallas_kernel(dtype, shape):
    jdt, tdt, tol = DTYPES[dtype]
    inputs = make_inputs(**shape)
    expected = np.asarray(cand_score_pallas(*as_jax(inputs, jdt), 0.2, True))
    twin = cand_scorer.cand_score_reference(*as_torch(inputs, tdt), alpha=0.2)
    assert twin.dtype == torch.float32 and twin.shape == expected.shape
    np.testing.assert_allclose(twin.numpy(), expected, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [dict(bt=16, k=6), dict(bt=13, k=7, c=40, m1=24)])
def test_twin_matches_jax_reference(dtype, shape):
    jdt, tdt, tol = DTYPES[dtype]
    inputs = make_inputs(**shape, seed=1)
    expected = np.asarray(jax_cand_score_reference(*as_jax(inputs, jdt), 0.2))
    twin = cand_scorer.cand_score_reference(*as_torch(inputs, tdt), alpha=0.2)
    np.testing.assert_allclose(twin.numpy(), expected, rtol=tol, atol=tol)


def test_wrapper_on_cpu_runs_the_twin_without_a_launch():
    operands = as_torch(make_inputs(bt=13, k=7, c=40), torch.float32)
    before = cand_scorer.launches
    out = cand_scorer.cand_score_kernel(*operands, alpha=0.2)
    assert cand_scorer.launches == before
    torch.testing.assert_close(
        out, cand_scorer.cand_score_reference(*operands, alpha=0.2), rtol=0, atol=0
    )
    assert out.shape == (13, 7)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    operands = as_torch(make_inputs(), torch.float32)
    with pytest.raises(TypeError):
        cand_scorer.cand_score_kernel(operands[0].to(torch.bfloat16), *operands[1:])
    with pytest.raises(TypeError):
        cand_scorer.cand_score_kernel(*(t.double() for t in operands))
    with pytest.raises(ValueError, match="i_rows"):
        cand_scorer.cand_score_kernel(operands[0][:-1], *operands[1:])
    with pytest.raises(ValueError, match="b2"):
        bad = list(operands)
        bad[8] = bad[8][:-1]
        cand_scorer.cand_score_kernel(*bad)
    with pytest.raises(ValueError, match="u must be"):
        cand_scorer.cand_score_kernel(operands[0], operands[1][:0], *operands[2:])
    with pytest.raises(ValueError, match="device"):
        cand_scorer.cand_score_kernel(operands[0].to("meta"), *operands[1:])


GRADS = ("di", "du", "dp", "dcar_w", "dcar_b", "dw1", "db1", "dw2", "db2",
         "dw3", "db3", "dw4")


def _cotangent(bt, k, seed=3):
    return np.random.RandomState(seed).randn(bt, k).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [dict(bt=16, k=6), dict(bt=8, k=50, c=48)])
def test_bwd_twin_matches_pallas_vjp(dtype, shape):
    jdt, tdt, _ = DTYPES[dtype]
    tol = 2e-4 if dtype == "f32" else 2e-2
    inputs = make_inputs(**shape, seed=2)
    jax_args = as_jax(inputs, jdt)
    _, residuals = jax_cand_scorer._fwd_impl(*jax_args, 0.2, True, stash_nc=True)
    jax_nc = np.asarray(residuals[12].astype(jnp.float32))
    operands = as_torch(inputs, tdt)
    scores, nc = cand_scorer.cand_score_reference(*operands, alpha=0.2, return_nc=True)
    diff = np.abs(nc.float().numpy() - jax_nc)
    if dtype == "bf16":
        assert diff.max() <= 2.0 ** -8 and (diff > 0).mean() <= 1e-3
    else:
        assert diff.max() <= 1e-6
    g = _cotangent(shape["bt"], shape["k"])
    _, vjp = jax.vjp(lambda *a: cand_score_pallas(*a, 0.2, True), *jax_args)
    expected = vjp(jnp.asarray(g))
    got = cand_scorer.cand_score_bwd_reference(*operands, nc, torch.from_numpy(g),
                                               alpha=0.2)
    for name, a, e, operand in zip(GRADS, got, expected, operands):
        assert a.dtype == operand.dtype and a.shape == operand.shape, name
        np.testing.assert_allclose(a.float().numpy(), np.asarray(e.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=name)


def test_bwd_twin_odd_shape_matches_jax_reference_vjp():
    inputs = make_inputs(bt=13, k=7, c=40, m1=24, m2=16, m3=8, seed=4)
    jax_args = as_jax(inputs, jnp.float32)
    g = _cotangent(13, 7, seed=5)
    _, vjp = jax.vjp(lambda *a: jax_cand_score_reference(*a, 0.2), *jax_args)
    expected = vjp(jnp.asarray(g))
    operands = as_torch(inputs, torch.float32)
    _, nc = cand_scorer.cand_score_reference(*operands, return_nc=True)
    got = cand_scorer.cand_score_bwd_kernel(*operands, nc, torch.from_numpy(g))
    for name, a, e in zip(GRADS, got, expected):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_cand_score_function_matches_autograd_of_the_twin():
    operands = as_torch(make_inputs(bt=13, k=7, c=40, m1=24, seed=6), torch.float32)
    g = torch.from_numpy(_cotangent(13, 7, seed=7))
    fused = [t.clone().requires_grad_() for t in operands]
    plain = [t.clone().requires_grad_() for t in operands]
    before = (cand_scorer.launches, cand_scorer.stash_launches, cand_scorer.bwd_launches)
    (cand_scorer.cand_score(*fused, alpha=0.2) * g).sum().backward()
    (cand_scorer.cand_score_reference(*plain, alpha=0.2) * g).sum().backward()
    assert before == (cand_scorer.launches, cand_scorer.stash_launches,
                      cand_scorer.bwd_launches)
    for name, a, b in zip(GRADS, fused, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6, msg=name)
    with torch.no_grad():  # grad off: the eval forward, no stash
        torch.testing.assert_close(
            cand_scorer.cand_score(*fused, alpha=0.2),
            cand_scorer.cand_score_reference(*operands, alpha=0.2), rtol=0, atol=0,
        )


def test_bwd_wrapper_rejects_what_the_kernel_cannot_take():
    operands = as_torch(make_inputs(), torch.float32)
    _, nc = cand_scorer.cand_score_reference(*operands, return_nc=True)
    g = torch.zeros(16, 6)
    with pytest.raises(ValueError, match="nc"):
        cand_scorer.cand_score_bwd_kernel(*operands, nc[:-1], g)
    with pytest.raises(ValueError, match="nc"):
        cand_scorer.cand_score_bwd_kernel(*operands, nc.to(torch.bfloat16), g)
    with pytest.raises(ValueError, match="cotangent"):
        cand_scorer.cand_score_bwd_kernel(*operands, nc, g[:-1])
