"""The port's UGRNN scans against the JAX package's.

``ugrnn_scan_reference`` (the CUDA kernel's plain twin, which the kernel
wrapper runs for CPU tensors) is held against the Pallas kernel
``ugrnn_scan_pallas`` in interpret mode: both widen to f32 and keep h in f32,
so float32 agrees at rtol 1e-5 / atol 1e-6 (sums in another order) and
bfloat16 at atol 2e-2 (one rounding of the output, on either side of a
bf16 step).  The plain ``ugrnn_scan`` is held against ``ops/rnn.py::ugrnn_scan``.
The backward twin ``ugrnn_scan_bwd_reference`` is held against ``jax.vjp``
of ``ugrnn_scan_pallas`` at the gradient tolerances of
``tests/test_pallas_ugrnn.py`` (rtol 1e-4 / atol 1e-5, f32), with units 9
and 255 and padded steps, and in bf16 at 2e-2; ``UGRNNScan`` against
autograd through the forward twin.  The CUDA kernels themselves are tested
on the card by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.ops.pallas.ugrnn_pallas import ugrnn_scan_pallas
from chameleon_recsys_tpu.ops.rnn import ugrnn_scan as jax_ugrnn_scan

from chameleon_recsys_tpu_torch.ops.kernels import ugrnn
from chameleon_recsys_tpu_torch.ops.kernels.ugrnn import (
    UGRNNScan,
    ugrnn_scan_bwd_kernel,
    ugrnn_scan_bwd_reference,
    ugrnn_scan_kernel,
    ugrnn_scan_reference,
)
from chameleon_recsys_tpu_torch.ops.rnn import StackedUGRNN, ugrnn_scan

_DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
           "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, t, units, partial_mask=True):
    rng = np.random.RandomState(seed)
    x_proj = (rng.randn(b, t, 2 * units) * 0.5).astype(np.float32)
    w_hh = (rng.randn(units, 2 * units) * 0.3).astype(np.float32)
    if partial_mask:
        lengths = rng.randint(0, t + 1, size=b)
        lengths[0] = t
        mask = np.arange(t)[None, :] < lengths[:, None]
    else:
        mask = np.ones((b, t), bool)
    return x_proj, w_hh, mask


def _to_both(x_proj, w_hh, mask, dtype):
    _, jdt, tdt = _DTYPES[dtype]
    jax_args = (jnp.asarray(x_proj, jdt), jnp.asarray(w_hh, jdt), jnp.asarray(mask))
    # the same rounded values on both sides
    torch_args = (
        torch.from_numpy(np.array(jax_args[0].astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.array(jax_args[1].astype(jnp.float32))).to(tdt),
        torch.from_numpy(mask),
    )
    return jax_args, torch_args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,t,units,partial",
    [(4, 6, 12, True), (3, 4, 9, False), (5, 7, 9, True), (3, 5, 255, True)],
)
def test_reference_matches_pallas(dtype, b, t, units, partial):
    jax_args, torch_args = _to_both(*_inputs(b * t + units, b, t, units, partial), dtype)
    expected = ugrnn_scan_pallas(*jax_args, 1.0, True)
    got = ugrnn_scan_reference(*torch_args, 1.0)
    assert got.dtype == torch_args[0].dtype and got.shape == (b, t, units)
    expected = np.asarray(expected.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), expected, atol=2e-2)


def test_kernel_wrapper_on_cpu_runs_the_reference():
    _, (x, w, m) = _to_both(*_inputs(3, 4, 6, 12), "float32")
    before = ugrnn.launches
    out = ugrnn_scan_kernel(x, w, m, 1.0)
    assert ugrnn.launches == before  # no kernel launched on the CPU
    torch.testing.assert_close(out, ugrnn_scan_reference(x, w, m, 1.0), rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad",
    ["odd_width", "w_shape", "mask_dtype", "mask_shape", "dtype", "mixed_dtype",
     "device"],
)
def test_kernel_wrapper_rejects_bad_inputs(bad):
    _, (x, w, m) = _to_both(*_inputs(4, 2, 3, 5), "float32")
    if bad == "odd_width":
        x = x[..., :-1]
    elif bad == "w_shape":
        w = w[:, :-2]
    elif bad == "mask_dtype":
        m = m.to(torch.int32)
    elif bad == "mask_shape":
        m = m[:, :-1]
    elif bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "mixed_dtype":
        w = w.to(torch.bfloat16)
    else:
        x, w, m = x.to("meta"), w.to("meta"), m.to("meta")
    with pytest.raises((ValueError, TypeError)):
        ugrnn_scan_kernel(x, w, m)


@pytest.mark.parametrize("partial", [True, False])
def test_plain_scan_matches_jax_scan(partial):
    x_proj, w_hh, mask = _inputs(11, 4, 6, 12, partial)
    expected = jax_ugrnn_scan(jnp.asarray(x_proj), jnp.asarray(w_hh), jnp.asarray(mask))
    got = ugrnn_scan(torch.from_numpy(x_proj), torch.from_numpy(w_hh),
                     torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


def test_stacked_zeroes_padded_steps_and_routes_to_kernel():
    torch.manual_seed(0)
    x = torch.randn(3, 5, 8)
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], dtype=torch.bool)
    plain = StackedUGRNN(8, 6, num_layers=2)
    routed = StackedUGRNN(8, 6, num_layers=2, use_kernel=True)
    for p in plain.parameters():
        torch.nn.init.uniform_(p, -0.3, 0.3)
    routed.load_state_dict(plain.state_dict())
    with torch.no_grad():
        out_plain, out_routed = plain(x, mask), routed(x, mask)
    assert (out_plain[~mask] == 0).all()
    # in f32 the plain scan and the kernel's twin are the same arithmetic
    torch.testing.assert_close(out_routed, out_plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,t,units,partial",
    [(4, 6, 12, True), (3, 4, 9, False), (5, 7, 9, True), (3, 5, 255, True)],
)
def test_bwd_twin_matches_pallas_vjp(dtype, b, t, units, partial):
    jax_args, (x, w, m) = _to_both(*_inputs(b + t + units, b, t, units, partial), dtype)
    g = np.random.RandomState(units).randn(b, t, units).astype(np.float32) * 0.3
    jdt = _DTYPES[dtype][1]
    _, vjp = jax.vjp(lambda xx, ww: ugrnn_scan_pallas(xx, ww, jax_args[2], 1.0, True),
                     jax_args[0], jax_args[1])
    jg = jnp.asarray(g, jdt)
    expected = vjp(jg)
    _, hs = ugrnn_scan_reference(x, w, m, 1.0, return_state=True)
    got = ugrnn_scan_bwd_reference(
        x, w, m, hs, torch.from_numpy(np.array(jg.astype(jnp.float32))).to(x.dtype)
    )
    before = ugrnn.bwd_launches
    wrapped = ugrnn_scan_bwd_kernel(
        x, w, m, hs, torch.from_numpy(np.array(jg.astype(jnp.float32))).to(x.dtype)
    )
    assert ugrnn.bwd_launches == before  # the CPU path runs the twin
    for name, a, a2, e in zip(("dx_proj", "dW_hh"), got, wrapped, expected):
        assert a.dtype == x.dtype, name
        torch.testing.assert_close(a2, a, rtol=0, atol=0)
        e = np.asarray(e.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), e, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(a.float().numpy(), e, rtol=2e-2, atol=2e-2,
                                       err_msg=name)


def test_ugrnn_scan_function_matches_autograd_of_the_twin():
    x, w, mask = (torch.from_numpy(v) for v in _inputs(12, 5, 7, 9))
    g = torch.from_numpy(np.random.RandomState(13).randn(5, 7, 9).astype(np.float32))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    (UGRNNScan.apply(xa, wa, mask, 1.0) * g).sum().backward()
    (ugrnn_scan_reference(xb, wb, mask, 1.0) * g).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-5, atol=1e-6)


def test_layer_records_through_the_function_only_with_grad():
    torch.manual_seed(1)
    layer = StackedUGRNN(8, 6, num_layers=2, use_kernel=True)
    for p in layer.parameters():
        torch.nn.init.uniform_(p, -0.3, 0.3)
    x = torch.randn(3, 5, 8)
    mask = torch.ones(3, 5, dtype=torch.bool)
    out = layer(x, mask)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(p.grad is not None for p in layer.parameters())
    with torch.no_grad():
        assert layer(x, mask).grad_fn is None
