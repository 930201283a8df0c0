"""The kernels' shape rule for bf16 widths that TMA cannot take, and the
build's cache key.

The GEMM core of ``csrc/cand_score_bwd.cu`` reads its operands through TMA
maps, which need 16-byte row strides: a bf16 C, and the first matching width
M1 (dW1's operand da1), must be multiples of 8.  For other widths the
wrapper zero-pads them (``cand_scorer.pad_widths``), runs the backward and
cuts the 12 gradients back (``cand_scorer.slice_widths``).  Here the plain
twin runs on both sides, on the CPU: padded and cut back it must give the
unpadded twin's gradients, bit for bit in float32 (the padded columns hold
exact zeros, so every real sum is the same) and within one rounding in
bfloat16, with the stashed nc and with nc recomputed.

The forward's TMA maps need every width a multiple of 8 in bf16 (C, M1, and
the M2, M3 of its last two wgmma products): ``pad_widths`` pads C and M1,
``pad_forward`` all four.  Padded, the twin's scores are the unpadded ones
bit for bit, and its nc cut back to C the unpadded nc, in both dtypes.

``build._lib_path`` names a library by the hash of its source and of every
``csrc/*.cuh`` header it may include, so that an edited header is rebuilt;
the test edits a copy of ``csrc`` and never writes into the package.
"""
import shutil

import numpy as np
import pytest
import torch

from chameleon_recsys_tpu_torch.ops.kernels import build, cand_scorer

GRADS = ("di", "du", "dp", "dcar_w", "dcar_b", "dw1", "db1", "dw2", "db2",
         "dw3", "db3", "dw4")


def _operands(bt, k, c, m1, m2, m3, dtype, seed):
    rng = np.random.RandomState(seed)

    def mk(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale).to(dtype)

    return [
        mk(bt * k, c, scale=0.5), mk(bt, c, scale=0.5), mk(bt, c, scale=0.5),
        mk(c, c, scale=c ** -0.5), mk(c, scale=0.1), mk(c, m1, scale=(2 / c) ** 0.5),
        mk(m1, scale=0.1), mk(m1, m2, scale=(2 / m1) ** 0.5), mk(m2, scale=0.1),
        mk(m2, m3, scale=(2 / m2) ** 0.5), mk(m3, scale=0.1), mk(m3, scale=m3 ** -0.5),
    ]


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
@pytest.mark.parametrize("m1", [24, 9])
@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("c", [37, 9, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_padded_backward_matches_the_unpadded_twin(dtype, c, k, m1, stash):
    bt = 5
    operands = _operands(bt, k, c, m1, 16, 8, dtype, seed=c * 10 + k + m1)
    g = torch.from_numpy(np.random.RandomState(k).randn(bt, k).astype(np.float32))
    nc = cand_scorer.cand_score_reference(*operands, return_nc=True)[1] if stash else None
    want = cand_scorer.cand_score_bwd_reference(*operands, nc, g)

    c_to, m1_to = -(-c // 8) * 8, -(-m1 // 8) * 8
    padded, padded_nc = cand_scorer.pad_widths(operands, nc, c_to, m1_to)
    assert padded[0].shape == (bt * k, c_to) and padded[3].shape == (c_to, c_to)
    assert padded[5].shape == (c_to, m1_to) and padded[7].shape == (m1_to, 16)
    for t in padded[:8] + ((padded_nc,) if stash else ()):
        assert t.is_contiguous()
    got = cand_scorer.slice_widths(
        cand_scorer.cand_score_bwd_reference(*padded, padded_nc, g), c, m1)

    for name, a, b, operand in zip(GRADS, got, want, operands):
        assert a.dtype == operand.dtype and a.shape == operand.shape, name
        assert a.is_contiguous(), name
        if dtype == torch.float32:
            assert torch.equal(a, b), name
        else:  # one bf16 rounding: 2^-8 of the value
            diff = (a.float() - b.float()).abs()
            assert bool((diff <= 2.0 ** -8 * b.float().abs()).all()), name


@pytest.mark.parametrize("m1", [9, 24])
@pytest.mark.parametrize("c", [9, 37, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_padded_forward_matches_the_unpadded_twin(dtype, c, m1):
    bt, k = 5, 3
    operands = _operands(bt, k, c, m1, 5, 3, dtype, seed=c * 10 + m1)
    scores, nc = cand_scorer.cand_score_reference(*operands, return_nc=True)
    c_to, m1_to = -(-c // 8) * 8, -(-m1 // 8) * 8
    padded, _ = cand_scorer.pad_widths(operands, None, c_to, m1_to)
    full = cand_scorer.pad_forward(operands)
    assert tuple(full[0].shape) == (bt * k, c_to) and tuple(full[5].shape) == (c_to, m1_to)
    assert [tuple(t.shape) for t in full[7:]] == [(m1_to, 8), (8,), (8, 8), (8,), (8,)]
    assert all(t.is_contiguous() for t in full)
    for ops in (padded, full):
        got, got_nc = cand_scorer.cand_score_reference(*ops, return_nc=True)
        assert torch.equal(got, scores)
        assert got_nc.shape == (bt * k, c_to)
        assert torch.equal(got_nc[:, :c], nc)
        assert not got_nc[:, c:].any()


def test_lib_path_changes_with_every_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["sm90_gemm.cuh", "ugrnn_common.cuh"]
    before = build._lib_path("cand_score_bwd", csrc)
    assert before == build._lib_path("cand_score_bwd", build.CSRC)
    assert before.parent == build.BUILD_DIR and before.name.startswith("cand_score_bwd-")

    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after_header = build._lib_path("cand_score_bwd", csrc)
    assert after_header != before
    # every source's key moves with a header, and with its own text
    assert build._lib_path("ugrnn_fwd", csrc) != build._lib_path("ugrnn_fwd", build.CSRC)
    source = csrc / "cand_score_bwd.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert build._lib_path("cand_score_bwd", csrc) not in (before, after_header)
    # a new header counts too
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build._lib_path("ugrnn_fwd", csrc) != build._lib_path("ugrnn_fwd", build.CSRC)
    assert build._lib_path("cand_score_bwd", build.CSRC) == before
