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
from chameleon_recsys_tpu_torch.train.steps import _batch_all_clicks, eval_step

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
@pytest.mark.parametrize(
    "b,t,units", [(256, 19, 255), (5, 7, 9), (3, 4, 1024)]
)
def test_ugrnn_bwd_kernel_matches_reference(card, dtype, b, t, units):
    x, w, mask = (v.to(card) for v in _inputs(b, t, units, dtype, seed=1))
    out, hs = ugrnn.ugrnn_scan_kernel(x, w, mask, return_state=True)
    ref_out, ref_hs = ugrnn.ugrnn_scan_reference(x, w, mask, return_state=True)
    torch.testing.assert_close(hs, ref_hs, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, ref_hs.to(dtype), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 8e-3)
    g = (torch.randn(b, t, units, generator=torch.Generator().manual_seed(2))
         .to(dtype).to(card))
    before = ugrnn.bwd_launches
    dx, dw = ugrnn.ugrnn_scan_bwd_kernel(x, w, mask, hs, g)
    torch.cuda.synchronize()
    assert ugrnn.bwd_launches == before + 1
    assert dx.dtype == dtype and dw.dtype == dtype
    ref_dx, ref_dw = ugrnn.ugrnn_scan_bwd_reference(x, w, mask, hs, g)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    _close_to_scale(dx, ref_dx, tol, "dx_proj")
    _close_to_scale(dw, ref_dw, tol, "dW_hh")


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
    (5, 3, 37, 9, 5, 3),  # C and M1 not multiples of 8: no vector loads
    (3, 2, 1344, 128, 7, 1),  # the widest C that fits shared memory in bf16
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
    wide = [t.to(card) for t in _scorer_inputs(2, 2, 32, 129, 8, 8, torch.float32)]
    with pytest.raises(ValueError):
        cand_scorer.cand_score_kernel(*wide)
    too_wide = [t.to(card) for t in _scorer_inputs(2, 2, 1500, 128, 8, 8, torch.bfloat16)]
    with pytest.raises(RuntimeError):
        cand_scorer.cand_score_kernel(*too_wide)


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
