"""The fused scorer's gate: ``cand_scorer.kernel_takes`` and the model's branch.

``kernel_takes`` says from the widths alone whether the card's kernels take
them (the forward's, and for training the backward's limits: the first
matching layer's accumulators in registers, the bf16 forward's m64n128 last
two layers at most, each launch's shared memory).  The model (``models/nar.py``)
takes the fused branch only where it holds, else the plain branch, as the
JAX package's gate does for shapes its Pallas kernel cannot take.  On the
CPU the kernel wrapper runs its plain twin either way, so the branch taken
is read by counting the model's calls of ``cand_score``.

With a first matching layer wider than the kernels take (256, 8, 8; C 32)
the port's pooled eval forward and its train forward over the compacted
rows take the plain branch and match the JAX package's fused path (its
Pallas scorer in interpret mode, as ``tests/test_pooled_scoring.py`` runs
it) on the same seeded inputs and converted weights: float32 probabilities
at rtol 1e-5 / atol 1e-6 and the losses at rel 1e-5, the tolerances of
``tests/test_torch_eval_step.py`` (the same f32 arithmetic summed in another
order).  At (16, 8, 8) the same test sees the fused branch taken, so a gate
that always took the plain branch fails it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.data.synthetic import make_synthetic_corpus, synthetic_hour_sessions
from chameleon_recsys_tpu.data.collate import collate_sessions as jax_collate
from chameleon_recsys_tpu.models.nar import NARAux as JaxNARAux
from chameleon_recsys_tpu.ops.sampling import (
    sample_negatives_pooled as jax_sample_negatives_pooled,
    sample_negatives_pooled_rows as jax_sample_negatives_pooled_rows,
)
from chameleon_recsys_tpu.train.steps import (
    _batch_all_clicks as jax_batch_all_clicks,
    build_nar_train,
    nar_init_state,
    valid_click_mask as jax_valid_click_mask,
)

from chameleon_recsys_tpu_torch.models import nar as port_nar
from chameleon_recsys_tpu_torch.models.nar import NARAux
from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer
from chameleon_recsys_tpu_torch.ops.kernels.cand_scorer import kernel_limit, kernel_takes

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_torch_eval_step import jax_batches, port_aux_consts, port_model, to_port_stream, warm_stream
from test_torch_train_step import jax_compaction

BF16, F32 = torch.bfloat16, torch.float32
G1 = (1024, 128, 64, 32)  # C, M1, M2, M3


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_kernels_take_the_g1_widths(dtype, train):
    assert kernel_takes(*G1, dtype, train=train)
    assert kernel_limit(*G1, dtype, train=train) is None
    # and the tiny widths the JAX package's tests give its fused path
    assert kernel_takes(32, 16, 8, 8, dtype, train=train)


@pytest.mark.parametrize("widths,dtype,train,limit", [
    ((32, 256, 8, 8), BF16, True, "first matching layer has 256"),
    ((32, 256, 8, 8), BF16, False, "first matching layer has 256"),
    ((32, 256, 8, 8), F32, True, "first matching layer has 256"),
    ((32, 129, 8, 8), F32, False, "more than 128"),
    ((32, 121, 8, 8), BF16, False, None),  # padded to 128: taken
    ((1344, 128, 64, 32), BF16, True, None),  # one ring stage a warpgroup
    ((1544, 128, 64, 32), BF16, False, "C up to 1536, not 1544"),
    ((1537, 16, 8, 8), BF16, True, "C up to 1536, not 1544"),  # padded to 1544
    ((32, 16, 128, 128), BF16, False, None),  # the tail's m64n128 products
    ((32, 16, 136, 8), BF16, False, "second and third matching layers"),
    ((32, 16, 8, 129), BF16, False, "second and third matching layers"),
    ((2688, 128, 64, 32), F32, False, None),
    ((2689, 128, 64, 32), F32, False, "f32 forward needs 236288 bytes"),
    ((32, 128, 72, 40), BF16, True, "backward's row kernel needs 233728 bytes"),
    ((32, 16, 8, 8), torch.float16, False, "float32 or bfloat16"),
])
def test_kernel_limit_names_the_limit(widths, dtype, train, limit):
    found = kernel_limit(*widths, dtype, train=train)
    if limit is None:
        assert found is None and kernel_takes(*widths, dtype, train=train)
        return
    assert found is not None and limit in found, found
    assert not kernel_takes(*widths, dtype, train=train)


def test_the_limits_follow_the_kernels_layouts():
    """The widest bf16 C is 1536 (the block's 64 rows of pre in 24 k-blocks
    of 8 KB beside one 16 KB ring stage a warpgroup; up to C 1024 the rings
    have 3 stages, up to C 1280 two), whatever the matching widths; float32
    takes wider C (16 rows a block), 2,688 at M1 = 128; the backward's row
    kernel bounds the widths of training alone (M2 = M3 = 1,024 fit the f32
    forward, not the backward).  The byte counts are those the libraries
    report for these widths (``cand_score_fwd_smem_bytes``,
    ``cand_score_bwd_rows_smem_bytes``; the card tests compare them)."""
    assert cand_scorer._f32_fwd_smem_bytes(1024, 128, 64, 32) == 125696
    assert cand_scorer._bwd_smem_bytes(128, 64, 32, BF16) == 225536
    assert cand_scorer._bwd_smem_bytes(128, 64, 32, F32) == 190080
    assert kernel_takes(1536, 128, 128, 128, BF16) and kernel_takes(1529, 128, 64, 32, BF16)
    assert not kernel_takes(1537, 128, 64, 32, BF16)
    assert kernel_takes(1536, 128, 64, 32, BF16, train=True)
    assert kernel_takes(1280, 128, 64, 32, F32, train=True)
    assert kernel_takes(32, 16, 1024, 1024, F32)
    assert not kernel_takes(32, 16, 1024, 1024, F32, train=True)
    assert "backward's row kernel" in kernel_limit(32, 16, 1024, 1024, F32, train=True)


# ---------------------------------------------------------------------------
# the model's branch against the JAX package's fused path
# ---------------------------------------------------------------------------

NUM_ITEMS = 200


def config(matching, **overrides):
    return tiny_nar_config(matching_layer_sizes=matching, use_pallas_scorer=True,
                           **overrides)


@pytest.fixture(scope="module", params=[(256, 8, 8), (16, 8, 8)], ids=["m1_256", "m1_16"])
def world(request):
    matching = request.param
    art, sess = tiny_article_schema(NUM_ITEMS), tiny_session_schema(NUM_ITEMS)
    cfg = config(matching)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    hours = [synthetic_hour_sessions(corpus, sess, h, 2 * cfg.batch_size,
                                     cfg.max_session_length) for h in range(2)]
    ace = jnp.asarray(corpus.ace_matrix)
    metadata = {k: jnp.asarray(v) for k, v in corpus.metadata.items()}
    first = {k: jnp.asarray(v) for k, v in jax_collate(
        hours[0][: cfg.batch_size], sess, cfg.batch_size, cfg.max_session_length).items()}
    _, _, state = nar_init_state(cfg, sess, art, first, ace, metadata)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        state.params)
    return dict(matching=matching, art=art, sess=sess, corpus=corpus, hours=hours,
                ace=ace, metadata=metadata, state=state, params=params)


@pytest.fixture
def fused_calls(monkeypatch):
    """The number of the model's ``cand_score`` calls (the fused branch)."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return cand_scorer.cand_score(*args, **kwargs)

    monkeypatch.setattr(port_nar, "cand_score", counted)
    return calls


def _expected_calls(world, train):
    c = 32  # tiny_nar_config's car_embedding_size
    return int(kernel_takes(c, *world["matching"], F32, train=train))


def test_pooled_eval_forward_takes_the_gates_branch(world, fused_calls):
    cfg = config(world["matching"])
    jax_stream = warm_stream(world, cfg, 1)
    jax_batch = jax_batches(world, cfg, 1)[0]
    all_clicked, _ = jax_batch_all_clicks(jax_batch)
    pool, idx, ids = jax_sample_negatives_pooled(
        jax.random.PRNGKey(5), all_clicked, jax_stream.buffer_ids,
        num_negatives=cfg.eval_negative_samples,
        buffer_sample_size=cfg.eval_negative_sample_from_buffer,
    )
    idx, ids = idx[:, :-1], ids[:, :-1]
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    jax_out = build_nar_train(cfg, world["sess"], world["art"]).model.apply(
        {"params": params}, jax_batch,
        JaxNARAux(world["ace"], world["metadata"], jax_stream.recent_pop_norm,
                  jax_stream.buffer_ids),
        ids, train=False, rank=True, neg_pool=pool, neg_pool_idx=idx,
    )
    ace, metadata = port_aux_consts(world)
    stream = to_port_stream(jax_stream)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jax_batch.items()}
    with torch.inference_mode():
        out = port_model(world, cfg)(
            batch, NARAux(ace, metadata, stream.recent_pop_norm, stream.buffer_ids),
            torch.tensor(np.asarray(ids)), rank=True,
            neg_pool=torch.tensor(np.asarray(pool)),
            neg_pool_idx=torch.tensor(np.asarray(idx)),
        )
    assert len(fused_calls) == _expected_calls(world, train=False)
    assert len(fused_calls) == (world["matching"][0] <= 128)
    np.testing.assert_allclose(out.items_prob.numpy(), np.asarray(jax_out.items_prob),
                               rtol=1e-5, atol=1e-6)
    assert float(out.ce_loss) == pytest.approx(float(jax_out.ce_loss), rel=1e-5)


def test_train_forward_takes_the_gates_branch(world, fused_calls):
    """The train forward over the compacted valid rows (``scoring_rows``),
    with grad on: the gate reads the backward's limits too."""
    jax_batch = jax_batches(world, config(world["matching"]), 1)[0]
    b, t = np.asarray(jax_batch["item_clicked"]).shape
    n_valid = int(jax_valid_click_mask(jax_batch["session_size"], t, xp=np).sum())
    cfg = config(world["matching"], novelty_reg_factor=0.1,
                 train_valid_row_capacity=min(-(-n_valid // 8) * 8, b * t))
    jax_stream = warm_stream(world, cfg, 1)
    rows_sel, row_mask, row_click, _ = jax_compaction(jax_batch, cfg.train_valid_row_capacity)
    all_clicked, _ = jax_batch_all_clicks(jax_batch)
    pool, idx, ids = jax_sample_negatives_pooled_rows(
        jax.random.PRNGKey(7), all_clicked, jax_stream.buffer_ids, rows_sel // t, row_click,
        num_negatives=cfg.negative_samples,
        buffer_sample_size=cfg.negative_sample_from_buffer,
        mult=cfg.neg_sampling_multiplying_factor,
    )
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    jax_out = build_nar_train(cfg, world["sess"], world["art"]).model.apply(
        {"params": params}, jax_batch,
        JaxNARAux(world["ace"], world["metadata"], jax_stream.recent_pop_norm,
                  jax_stream.buffer_ids),
        ids, train=True, rank=False, neg_pool=pool, neg_pool_idx=idx,
        scoring_rows=(rows_sel, row_mask), rngs={"dropout": jax.random.PRNGKey(8)},
    )
    ace, metadata = port_aux_consts(world)
    stream = to_port_stream(jax_stream)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jax_batch.items()}
    model = port_model(world, cfg).train()
    out = model(
        batch, NARAux(ace, metadata, stream.recent_pop_norm, stream.buffer_ids),
        torch.tensor(np.asarray(ids)), train=True, neg_pool=torch.tensor(np.asarray(pool)),
        neg_pool_idx=torch.tensor(np.asarray(idx)),
        scoring_rows=(torch.tensor(np.asarray(rows_sel)), torch.tensor(np.asarray(row_mask))),
    )
    assert len(fused_calls) == _expected_calls(world, train=True)
    assert len(fused_calls) == (world["matching"][0] <= 128)
    np.testing.assert_allclose(out.items_prob.detach().numpy(),
                               np.asarray(jax_out.items_prob), rtol=1e-5, atol=1e-6)
    for name in ("ce_loss", "nov_reg_loss"):
        assert float(getattr(out, name).detach()) == pytest.approx(
            float(getattr(jax_out, name)), rel=1e-5), name
    (out.ce_loss - out.nov_reg_loss).backward()  # the branch is differentiable
    assert model.CAR_kernel.grad is not None and torch.isfinite(model.CAR_kernel.grad).all()
