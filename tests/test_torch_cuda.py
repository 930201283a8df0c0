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
