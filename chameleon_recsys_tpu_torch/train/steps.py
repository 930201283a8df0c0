"""The NAR train and eval steps.

Port of ``chameleon_recsys_tpu/train/steps.py`` (``build_nar_train``'s
``train_step_fn`` and ``eval_step_fn``).

``train_step``: with ``train_valid_row_capacity`` set, compact the valid
(session, step) rows of the batch to the front of the flat grid and keep the
first ``capacity`` (``compact_valid_rows``), sample ``negative_samples``
negatives for those rows only (``sample_negatives_pooled_rows``), else for
the whole grid; run the model with ``train=True``; take loss = XE + L2 -
novelty, back-propagate, step Adam; then fold the batch's clicks into the
streaming state.  ``train_compaction_groups > 1`` (the mesh layout) is not
ported.

``eval_step``: sample ``eval_negative_samples`` negatives per click from the
grid sampler, run the model over the whole [B, T] grid with ``rank=True``,
sum the in-graph ranking metrics, and fold the batch's clicks into the
stream (the temporal protocol snapshots and restores it around an eval
hour).

A ``torch.Generator`` stands in for the JAX state's ``rng``; both steps take
injected ``SamplerUniforms`` instead, for parity with the JAX draws.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..models.nar import NARAux, NARModel
from ..ops.sampling import (
    SamplerUniforms,
    sample_negatives_pooled,
    sample_negatives_pooled_rows,
)
from ..state.stream_state import StreamState, update_stream_state
from .loss import l2_regularization


def valid_click_mask(session_size, t: int) -> torch.Tensor:
    """[B] session sizes (a tensor or a numpy array) -> [B, t] bool: step s
    is a (click -> label) pair iff ``s < session_size - 1``, the model's
    loss mask."""
    seq_len = torch.as_tensor(session_size).to(torch.int32) - 1
    return torch.arange(t, device=seq_len.device)[None, :] < seq_len[:, None]


def _batch_all_clicks(batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """All clicked ids and timestamps with the final label column; the final
    label's timestamp is the session's last click time, as the reference
    reuses it."""
    all_clicked = torch.cat([batch["item_clicked"], batch["label_last_item"]], 1)
    ts = batch["event_timestamp"]
    last_ts = ts.max(dim=1, keepdim=True).values
    all_ts = torch.cat([ts, last_ts], 1)
    return all_clicked, torch.where(all_clicked != 0, all_ts, 0)


def device_ranking_metrics(
    predicted_ids: torch.Tensor,  # [B, T, 1+K] ranked desc
    labels: torch.Tensor,  # [B, T]
    loss_mask: torch.Tensor,  # [B, T] f32
    top_n: int,
) -> Dict[str, torch.Tensor]:
    """HR@N and MRR@N sums with their count, for streaming accumulation."""
    hits = predicted_ids[..., :top_n] == labels[..., None]  # [B, T, N]
    any_hit = hits.any(-1)
    hit = any_hit.to(torch.float32) * loss_mask
    first_pos = hits.to(torch.int32).argmax(-1)  # the first hit
    rr = torch.where(any_hit, 1.0 / (1.0 + first_pos.to(torch.float32)), 0.0)
    rr = rr * loss_mask
    return {
        "hit_sum": hit.sum(),
        "rr_sum": rr.sum(),
        "label_count": loss_mask.sum(),
    }


class RowCompaction(NamedTuple):
    """The train step's selection of (session, step) rows."""

    rows_sel: torch.Tensor  # [M] int64 flat indices into the B*T grid
    row_mask: torch.Tensor  # [M] f32: 1 where the row is a valid click
    row_click: torch.Tensor  # [M] the row's clicked id
    n_valid: torch.Tensor  # [] int64 valid clicks in the batch
    dropped: torch.Tensor  # [] f32 valid clicks past the capacity


def compact_valid_rows(session_size, item_clicked, capacity: int) -> RowCompaction:
    """Partition the flat [B*T] grid valid-rows-first, stably and without a
    sort (each row's destination from two cumsums, the permutation by
    scattering the row numbers there), and keep the first ``capacity``
    rows (M = min(capacity, B*T))."""
    b, t = item_clicked.shape
    mask = valid_click_mask(session_size, t).reshape(-1)
    mi = mask.to(torch.int64)
    n_valid = mi.sum()
    dest = torch.where(
        mask, torch.cumsum(mi, 0) - 1, n_valid + torch.cumsum(1 - mi, 0) - 1
    )
    rows = torch.arange(b * t, device=mask.device)
    perm = torch.empty_like(rows).scatter_(0, dest, rows)
    rows_sel = perm[:capacity]
    row_mask = mask[rows_sel].to(torch.float32)
    return RowCompaction(
        rows_sel=rows_sel,
        row_mask=row_mask,
        row_click=item_clicked.reshape(-1)[rows_sel],
        n_valid=n_valid,
        dropped=(n_valid - row_mask.sum()).to(torch.float32),
    )


def _aux(stream: StreamState, ace_matrix, metadata) -> NARAux:
    return NARAux(
        ace_matrix=ace_matrix,
        metadata=dict(metadata),
        recent_pop_norm=stream.recent_pop_norm,
        buffer_ids=stream.buffer_ids,
    )


class TrainState(NamedTuple):
    """What a train step carries from one batch to the next.  The model's
    parameters (f32) and Adam's moments change in place; the stream and the
    step count are replaced."""

    model: NARModel
    optimizer: torch.optim.Optimizer
    stream: StreamState
    generator: torch.Generator
    step: int


def init_train_state(
    model: NARModel, stream: StreamState, generator: torch.Generator
) -> TrainState:
    """A fresh train state: Adam as ``optax.adam(lr, b1=0.9, b2=0.999,
    eps=1e-8)``, with no weight decay (the L2 term is in the loss)."""
    optimizer = torch.optim.Adam(
        model.parameters(), lr=model.cfg.learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=0.0,
    )
    return TrainState(model, optimizer, stream, generator, 0)


class _TrainInputs(NamedTuple):
    aux: NARAux
    pool: torch.Tensor
    neg_idx: torch.Tensor
    neg_ids: torch.Tensor
    scoring_rows: Optional[Tuple[torch.Tensor, torch.Tensor]]
    dropped: Optional[torch.Tensor]
    all_clicked: torch.Tensor
    all_ts: torch.Tensor


def _train_inputs(model, stream, batch, ace_matrix, metadata, generator,
                  uniforms) -> _TrainInputs:
    """What the model call of a train step takes besides the batch: the aux
    inputs, the compacted rows (with a capacity) and the sampler's pool and
    negatives for them (for the grid without one, the final label column
    dropped)."""
    cfg = model.cfg
    if cfg.train_compaction_groups > 1:
        raise NotImplementedError(
            "train_compaction_groups > 1 (the mesh layout) is not ported"
        )
    aux = _aux(stream, ace_matrix, metadata)
    all_clicked, all_ts = _batch_all_clicks(batch)
    sampler = dict(
        num_negatives=cfg.negative_samples,
        buffer_sample_size=cfg.negative_sample_from_buffer,
        mult=cfg.neg_sampling_multiplying_factor, generator=generator,
        uniforms=uniforms,
    )
    if cfg.train_valid_row_capacity is None:
        pool, neg_idx, neg_ids = sample_negatives_pooled(
            all_clicked, stream.buffer_ids, **sampler
        )
        return _TrainInputs(aux, pool, neg_idx[:, :-1], neg_ids[:, :-1], None,
                            None, all_clicked, all_ts)
    rows = compact_valid_rows(batch["session_size"], batch["item_clicked"],
                              cfg.train_valid_row_capacity)
    t = batch["item_clicked"].shape[1]
    pool, neg_idx, neg_ids = sample_negatives_pooled_rows(
        all_clicked, stream.buffer_ids, rows.rows_sel // t, rows.row_click,
        **sampler
    )
    return _TrainInputs(aux, pool, neg_idx, neg_ids,
                        (rows.rows_sel, rows.row_mask), rows.dropped,
                        all_clicked, all_ts)


def train_step(
    state: TrainState,
    batch: Mapping[str, torch.Tensor],
    ace_matrix: torch.Tensor,
    metadata: Mapping[str, torch.Tensor],
    *,
    uniforms: Optional[SamplerUniforms] = None,
):
    """One train batch -> (state', metrics).

    ``batch`` is a collated batch on the model's device.  The sampler draws
    from ``state.generator``, or takes ``uniforms`` (click keys [M, NC] with
    compaction, [B, L, NC] without).  After the step every parameter's
    ``.grad`` holds this batch's gradient.  Metrics: ``loss``, ``ce_loss``,
    ``reg_loss``, ``sessions``, ``clicks`` and, with a capacity,
    ``dropped_clicks``.
    """
    model, cfg = state.model, state.model.cfg
    stream = state.stream
    with torch.enable_grad():
        inputs = _train_inputs(model, stream, batch, ace_matrix, metadata,
                               state.generator, uniforms)
        out = model(batch, inputs.aux, inputs.neg_ids, train=True,
                    neg_pool=inputs.pool, neg_pool_idx=inputs.neg_idx,
                    scoring_rows=inputs.scoring_rows)
        reg = l2_regularization(model, cfg.reg_weight_decay)
        loss = out.ce_loss + reg - out.nov_reg_loss
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    # optax updates every leaf; torch's Adam skips a parameter whose grad is
    # None, so give such a parameter a zero gradient
    for param in model.parameters():
        if param.grad is None:
            param.grad = torch.zeros_like(param)
    state.optimizer.step()
    metrics = {
        "loss": loss.detach(),
        "ce_loss": out.ce_loss.detach(),
        "reg_loss": reg.detach(),
        "sessions": (batch["session_size"] > 0).sum(),
        "clicks": out.loss_mask.sum(),
    }
    if inputs.dropped is not None:
        metrics["dropped_clicks"] = inputs.dropped
    new_stream = update_stream_state(stream, inputs.all_clicked, inputs.all_ts, cfg)
    return state._replace(stream=new_stream, step=state.step + 1), metrics


def _eval_inputs(model, stream, batch, ace_matrix, metadata, generator, uniforms):
    """What the model call of an eval step takes besides the batch: the aux
    inputs and the grid sampler's pool and per-click negatives (the final
    label column dropped), with the batch's clicks and their timestamps."""
    cfg = model.cfg
    aux = _aux(stream, ace_matrix, metadata)
    all_clicked, all_ts = _batch_all_clicks(batch)
    # cfg.approx_negative_topk is a TPU-only approximation: the sampler here
    # always takes the exact top-k (see ops/sampling.py)
    pool, neg_idx, neg_ids = sample_negatives_pooled(
        all_clicked,
        stream.buffer_ids,
        num_negatives=cfg.eval_negative_samples,
        buffer_sample_size=cfg.eval_negative_sample_from_buffer,
        mult=cfg.neg_sampling_multiplying_factor,
        generator=generator,
        uniforms=uniforms,
    )
    # the final label column has no next click to score
    neg_idx, neg_ids = neg_idx[:, :-1], neg_ids[:, :-1]
    return aux, pool, neg_idx, neg_ids, all_clicked, all_ts


@torch.inference_mode()
def eval_step(
    model: NARModel,
    stream: StreamState,
    batch: Mapping[str, torch.Tensor],
    ace_matrix: torch.Tensor,
    metadata: Mapping[str, torch.Tensor],
    *,
    generator: torch.Generator,
    fetch_full_ranking: bool = True,
    uniforms: Optional[SamplerUniforms] = None,
):
    """One eval batch -> (stream', metrics, fetches).

    ``batch`` is a collated batch (``data.collate``) on the model's device.
    The sampler draws from ``generator``, or takes ``uniforms`` when given
    (for parity with another implementation's draws).  Under
    ``fetch_full_ranking=False`` the fetches hold only the top
    ``metrics_top_n`` predicted ids and no probabilities.
    """
    cfg = model.cfg
    aux, pool, neg_idx, neg_ids, all_clicked, all_ts = _eval_inputs(
        model, stream, batch, ace_matrix, metadata, generator, uniforms
    )
    out = model(batch, aux, neg_ids, rank=True, neg_pool=pool, neg_pool_idx=neg_idx)

    metrics = device_ranking_metrics(
        out.predicted_ids, batch["label_next_item"], out.loss_mask,
        cfg.metrics_top_n,
    )
    metrics["ce_loss"] = out.ce_loss
    metrics["clicks"] = out.loss_mask.sum()
    metrics["sessions"] = (batch["session_size"] > 0).sum()
    fetches = {
        "labels": batch["label_next_item"],
        "neg_items": out.candidate_ids[..., 1:],
        "clicked_items": batch["item_clicked"],
    }
    if fetch_full_ranking:
        fetches["predicted_ids"] = out.predicted_ids
        fetches["predicted_probs"] = out.predicted_probs
    else:
        fetches["predicted_ids"] = out.predicted_ids[..., : cfg.metrics_top_n]
    new_stream = update_stream_state(stream, all_clicked, all_ts, cfg)
    return new_stream, metrics, fetches


@torch.inference_mode()
def eval_scorer_operands(
    model: NARModel,
    stream: StreamState,
    batch: Mapping[str, torch.Tensor],
    ace_matrix: torch.Tensor,
    metadata: Mapping[str, torch.Tensor],
    *,
    generator: torch.Generator,
    uniforms: Optional[SamplerUniforms] = None,
):
    """The fused scorer's operands (``NARModel.scorer_operands``) of the
    ``eval_step`` call with the same arguments: a generator in the same
    state, or the same uniforms, draws the same negatives."""
    aux, pool, neg_idx, _, _, _ = _eval_inputs(
        model, stream, batch, ace_matrix, metadata, generator, uniforms
    )
    return model.scorer_operands(batch, aux, pool, neg_idx)


@torch.no_grad()
def train_scorer_operands(
    model: NARModel,
    stream: StreamState,
    batch: Mapping[str, torch.Tensor],
    ace_matrix: torch.Tensor,
    metadata: Mapping[str, torch.Tensor],
    *,
    generator: torch.Generator,
    uniforms: Optional[SamplerUniforms] = None,
):
    """The fused scorer's operands (``NARModel.scorer_operands``) of the
    ``train_step`` call with the same model, stream and batch: a generator
    in the same state, or the same uniforms, draws the same negatives."""
    inputs = _train_inputs(model, stream, batch, ace_matrix, metadata,
                           generator, uniforms)
    return model.scorer_operands(batch, inputs.aux, inputs.pool, inputs.neg_idx,
                                 inputs.scoring_rows)
