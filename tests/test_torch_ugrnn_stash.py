"""The UGRNN scan's training stash and the resident kernels' width predicate.

In training the forward keeps the f32 pre-activations ``acts = x_proj +
h_prev . W_hh`` and the backward reads the gates from them instead of
recomputing ``h_prev . W_hh`` in its serial chain.  On the CPU the forward
twin returns that stash (``return_acts``) and the backward twin consumes it:
the same f32 operations on the same states as the twin's recompute, so the
gradients are bit-equal to the recompute's.  ``UGRNNScan`` on that path is
held against ``jax.vjp`` of ``ugrnn_scan_pallas`` in interpret mode at units
9 and 255 with padded steps: the output at rtol 1e-5 / atol 1e-6 and the
gradients at rtol 1e-4 / atol 1e-5, the tolerances of
``tests/test_pallas_ugrnn.py``.

``resident_takes`` (which instantiation the wrappers launch on the card) is a
pure function of the widths; its edges are those of the layout arithmetic
in ``csrc/ugrnn_common.cuh``, which the card tests hold against the
library's own count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.ops.pallas.ugrnn_pallas import ugrnn_scan_pallas

from chameleon_recsys_tpu_torch.ops.kernels import ugrnn
from chameleon_recsys_tpu_torch.ops.kernels.ugrnn import (
    UGRNNScan,
    resident_takes,
    ugrnn_scan_bwd_kernel,
    ugrnn_scan_bwd_reference,
    ugrnn_scan_kernel,
    ugrnn_scan_reference,
)


def _inputs(seed, b, t, units):
    rng = np.random.RandomState(seed)
    x_proj = (rng.randn(b, t, 2 * units) * 0.5).astype(np.float32)
    w_hh = (rng.randn(units, 2 * units) * 0.3 / np.sqrt(units / 12)).astype(np.float32)
    lengths = rng.randint(0, t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] < lengths[:, None]
    g = (rng.randn(b, t, units) * 0.3).astype(np.float32)
    return x_proj, w_hh, mask, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,units", [(5, 7, 9), (3, 5, 255), (2, 1, 4)])
def test_stash_is_the_recompute(dtype, b, t, units):
    x, w, mask, g = (torch.from_numpy(v) for v in _inputs(b * t + units, b, t, units))
    x, w, g = x.to(dtype), w.to(dtype), g.to(dtype)
    out, hs, acts = ugrnn_scan_reference(x, w, mask, 1.0, return_acts=True)
    assert acts.dtype == torch.float32 and acts.shape == (b, t, 2 * units)
    out2, hs2 = ugrnn_scan_reference(x, w, mask, 1.0, return_state=True)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    torch.testing.assert_close(hs, hs2, rtol=0, atol=0)
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    torch.testing.assert_close(acts, x.float() + h_prev @ w.float(), rtol=0, atol=0)
    stash = ugrnn_scan_bwd_reference(None, w, mask, hs, g, 1.0, acts=acts)
    recompute = ugrnn_scan_bwd_reference(x, w, mask, hs, g, 1.0)
    for got, want in zip(stash, recompute):
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("units", [9, 255])
def test_ugrnn_scan_function_with_stash_matches_pallas_vjp(units, monkeypatch):
    b, t = 4, 6
    x_np, w_np, mask_np, g_np = _inputs(units, b, t, units)
    out_jax, vjp = jax.vjp(
        lambda xx, ww: ugrnn_scan_pallas(xx, ww, jnp.asarray(mask_np), 1.0, True),
        jnp.asarray(x_np), jnp.asarray(w_np))
    gx_jax, gw_jax = vjp(jnp.asarray(g_np))

    seen = []
    twin = ugrnn.ugrnn_scan_bwd_reference

    def recording(x_proj, *args, acts=None):
        seen.append((x_proj, acts))
        return twin(x_proj, *args, acts=acts)

    monkeypatch.setattr(ugrnn, "ugrnn_scan_bwd_reference", recording)
    x = torch.from_numpy(x_np).requires_grad_()
    w = torch.from_numpy(w_np).requires_grad_()
    out = UGRNNScan.apply(x, w, torch.from_numpy(mask_np), 1.0)
    (out * torch.from_numpy(g_np)).sum().backward()
    # the backward twin consumed the forward's stash, not x_proj
    assert len(seen) == 1 and seen[0][0] is None and seen[0][1].shape == (b, t, 2 * units)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_jax), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_jax), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw_jax), rtol=1e-4, atol=1e-5)


def test_kernel_wrappers_on_cpu_return_and_consume_the_stash():
    x, w, mask, g = (torch.from_numpy(v) for v in _inputs(3, 3, 5, 12))
    before = (ugrnn.launches, ugrnn.bwd_launches, ugrnn.resident_launches,
              ugrnn.bwd_resident_launches)
    out, hs, acts = ugrnn_scan_kernel(x, w, mask, 1.0, return_acts=True)
    dx, dw = ugrnn_scan_bwd_kernel(None, w, mask, hs, g, 1.0, acts=acts)
    assert (ugrnn.launches, ugrnn.bwd_launches, ugrnn.resident_launches,
            ugrnn.bwd_resident_launches) == before  # the CPU path runs the twins
    ref = ugrnn_scan_reference(x, w, mask, 1.0, return_acts=True)
    for got, want in zip((out, hs, acts), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip((dx, dw), ugrnn_scan_bwd_reference(x, w, mask, hs, g, 1.0)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["neither", "acts_dtype", "acts_shape", "w_shape",
                                 "mask_dtype"])
def test_bwd_wrapper_rejects_bad_inputs(bad):
    x, w, mask, g = (torch.from_numpy(v) for v in _inputs(4, 2, 3, 5))
    _, hs, acts = ugrnn_scan_reference(x, w, mask, 1.0, return_acts=True)
    x_arg = None
    if bad == "neither":
        acts = None
    elif bad == "acts_dtype":
        acts = acts.double()
    elif bad == "acts_shape":
        acts = acts[..., :-2]
    elif bad == "w_shape":
        w = w[:, :-2]
    else:
        mask = mask.to(torch.int32)
    with pytest.raises((ValueError, TypeError)):
        ugrnn_scan_bwd_kernel(x_arg, w, mask, hs, g, 1.0, acts=acts)


@pytest.mark.parametrize(
    "units,dtype,train,takes",
    [
        (255, torch.bfloat16, False, True),  # G1: a cluster of 2
        (255, torch.bfloat16, True, True),
        (255, torch.float32, True, True),  # G1 in f32: a cluster of 3
        (9, torch.float32, True, True),
        (1, torch.bfloat16, True, True),
        (648, torch.bfloat16, True, True),  # the bf16 backward's edge
        (649, torch.bfloat16, True, False),
        (649, torch.bfloat16, False, True),
        (656, torch.bfloat16, False, True),  # the bf16 forward's edge
        (657, torch.bfloat16, False, False),
        (456, torch.float32, True, True),  # the f32 edge, forward and backward
        (457, torch.float32, True, False),
        (456, torch.float32, False, True),
        (457, torch.float32, False, False),
        (1024, torch.bfloat16, False, False),  # the streaming kernels' widest
        (255, torch.float16, False, False),
    ],
)
def test_resident_takes_is_a_width_predicate(units, dtype, train, takes):
    assert resident_takes(units, dtype, train=train) is takes


def test_resident_layout_at_g1():
    """At U 255 the bf16 slices fit a cluster of 2 CTAs and the f32 ones a
    cluster of 3, at every row count the launch may pick; the predicate
    holds across every width up to its edge (no gaps)."""
    for dtype, n in ((torch.bfloat16, 2), (torch.float32, 3)):
        for bwd in (False, True):
            for rows in (1, 2, 4, 8):
                layout = ugrnn._resident_layout(255, dtype, bwd, rows)
                assert layout.n == n and layout.smem <= ugrnn._SMEM_LIMIT
                assert layout.ksplit * layout.uq <= ugrnn._MAX_THREADS
    for dtype in (torch.bfloat16, torch.float32):
        for train in (False, True):
            takes = [resident_takes(u, dtype, train) for u in range(1, 1025)]
            edge = takes.index(False)
            assert all(takes[:edge]) and not any(takes[edge:])
