"""The port's CUDA kernels against their plain twins, on the card.

These tests need an NVIDIA card (a hand-written CUDA kernel has no CPU mode)
and skip without one.  They import nothing of JAX, so they also run where
JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 at atol 1e-5 (the same f32 arithmetic, summed in another
order); a bfloat16 output at atol 8e-3, two bf16 steps below 1.0 (|h| < 1),
since one rounding of the same f32 value may land on either side.
"""
import pytest
import torch

from chameleon_recsys_tpu_torch.ops.kernels import ugrnn

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,t,units", [(32, 19, 255), (256, 19, 255), (5, 7, 9), (3, 4, 1024)]
)
def test_ugrnn_kernel_matches_reference(card, dtype, b, t, units):
    x, w, mask = (v.to(card) for v in _inputs(b, t, units, dtype))
    before = ugrnn.launches
    out = ugrnn.ugrnn_scan_kernel(x, w, mask)
    torch.cuda.synchronize()
    assert ugrnn.launches == before + 1
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
