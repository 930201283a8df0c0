"""The NAR train and eval steps.

Port of ``chameleon_recsys_tpu/train/steps.py`` (``build_nar_train``'s
``train_step_fn`` and ``eval_step_fn``).

``train_step``: with ``train_valid_row_capacity`` set, compact the valid
(session, step) rows of the batch to the front of the flat grid and keep the
first ``capacity`` (``compact_valid_rows``), sample ``negative_samples``
negatives for those rows only (``sample_negatives_pooled_rows``), else for
the whole grid; run the model with ``train=True`` (at ``keep_prob`` < 1 the
model takes the dense path over the sampled ``neg_ids``, as the JAX model
does, with its dropout masks drawn from the state's generator after the
sampler's draws); take loss = XE + L2 - novelty, back-propagate, step Adam;
then fold the batch's clicks into the streaming state.  With
``train_compaction_groups`` = G > 1 the compaction runs per group of B / G
sessions (G = the data-parallel width of the mesh layout): each group's
valid rows first, ``capacity / G`` rows a group.  On one device that
changes which rows are kept, not how they are scored: the sampler and the
model look the kept rows up in the flat grid.

``eval_step``: sample ``eval_negative_samples`` negatives per click from the
grid sampler, run the model over the whole [B, T] grid with ``rank=True``,
sum the in-graph ranking metrics, and fold the batch's clicks into the
stream (the temporal protocol snapshots and restores it around an eval
hour).

A ``torch.Generator`` stands in for the JAX state's ``rng``; both steps take
injected ``SamplerUniforms`` instead, for parity with the JAX draws.

Under a mesh both steps take ``shard`` (``parallel/sharded.py``, which
builds it): the batch is then the rank's block of the global batch; the pool
and the stream update take the global batch's clicks; every draw is made at
the global shape and the rank keeps its block (the rank's compaction is
group ``data_index`` of the single-device grouped step); the losses divide
by the global valid-click count; the gradients are summed over the data
group before Adam; the metrics are the global batch's.

``train_step``'s phases are spans of the program (``utils/profiling.py``):
``nar.train_step.sample`` (compaction and the sampler), ``.forward`` (the
model and the loss), ``.backward``, ``.optimizer`` (the zero gradients,
their sum under a mesh, Adam) and ``.stream``.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..models.nar import NARAux, NARModel
from ..ops.sampling import (
    SamplerUniforms,
    draw_uniforms,
    sample_negatives_pooled,
    sample_negatives_pooled_rows,
)
from ..state.stream_state import StreamState, update_stream_state
from ..utils.profiling import span
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


def compact_valid_rows(session_size, item_clicked, capacity: int,
                       groups: int = 1) -> RowCompaction:
    """Partition the flat [B*T] grid valid-rows-first, stably and without a
    sort (each row's destination from two cumsums, the permutation by
    scattering the row numbers there), and keep the first ``capacity``
    rows (M = min(capacity, B*T)).

    With ``groups`` = G > 1 (the JAX package's ``train_compaction_groups``)
    the grid is cut into G contiguous blocks of B / G sessions and each
    block is partitioned on its own, keeping its first ``capacity / G``
    rows; ``rows_sel`` lists group 0's rows, then group 1's, and so on, and
    a group's valid rows past its share are dropped (and counted) even where
    another group has room.  G must divide B*T, ``capacity`` and B."""
    b, t = item_clicked.shape
    if groups > 1 and ((b * t) % groups or capacity % groups or b % groups):
        raise ValueError(
            "train_compaction_groups must divide batch_size and "
            "train_valid_row_capacity"
        )
    r = (b * t) // groups
    mask = valid_click_mask(session_size, t).reshape(groups, r)
    mi = mask.to(torch.int64)
    n_group = mi.sum(1, keepdim=True)
    dest = torch.where(
        mask, torch.cumsum(mi, 1) - 1, n_group + torch.cumsum(1 - mi, 1) - 1
    )
    rows = torch.arange(r, device=mask.device).expand(groups, r)
    perm = torch.empty_like(dest).scatter_(1, dest, rows)
    rows_local = perm[:, : capacity // groups]
    row_mask = mask.gather(1, rows_local).reshape(-1).to(torch.float32)
    offsets = torch.arange(groups, device=mask.device)[:, None] * r
    n_valid = mi.sum()
    return RowCompaction(
        rows_sel=(rows_local + offsets).reshape(-1),
        row_mask=row_mask,
        row_click=item_clicked.reshape(groups, r).gather(1, rows_local).reshape(-1),
        n_valid=n_valid,
        dropped=(n_valid - row_mask.sum()).to(torch.float32),
    )


def _aux(stream: StreamState, ace_matrix, metadata, shard=None) -> NARAux:
    return NARAux(
        ace_matrix=ace_matrix,
        metadata=dict(metadata),
        recent_pop_norm=stream.recent_pop_norm,
        buffer_ids=stream.buffer_ids,
        shard=shard,
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
                  uniforms, shard=None) -> _TrainInputs:
    """What the model call of a train step takes besides the batch: the aux
    inputs, the compacted rows (with a capacity) and the sampler's pool and
    negatives for them (for the grid without one, the final label column
    dropped)."""
    cfg = model.cfg
    aux = _aux(stream, ace_matrix, metadata, shard)
    all_clicked, all_ts = _batch_all_clicks(batch if shard is None else shard.batch)
    sampler = dict(
        num_negatives=cfg.negative_samples,
        buffer_sample_size=cfg.negative_sample_from_buffer,
        mult=cfg.neg_sampling_multiplying_factor, generator=generator,
        uniforms=uniforms,
    )
    if cfg.train_valid_row_capacity is None:
        pool, neg_idx, neg_ids = sample_negatives_pooled(
            all_clicked, stream.buffer_ids, **sampler,
            sessions=None if shard is None else shard.sessions,
        )
        return _TrainInputs(aux, pool, neg_idx[:, :-1], neg_ids[:, :-1], None,
                            None, all_clicked, all_ts)
    groups = max(cfg.train_compaction_groups, 1)
    capacity = cfg.train_valid_row_capacity
    if shard is not None:
        # the rank's sessions are groups [d * G / dp, (d + 1) * G / dp) of
        # the single-device grouped step
        capacity //= shard.plan.data_parallelism
        groups //= shard.plan.data_parallelism
    rows = compact_valid_rows(batch["session_size"], batch["item_clicked"],
                              capacity, groups)
    t = batch["item_clicked"].shape[1]
    row_session = rows.rows_sel // t
    if shard is not None:
        row_session = row_session + shard.sessions.start
        if uniforms is None:
            uniforms = draw_uniforms(
                generator, *all_clicked.shape, stream.buffer_ids.shape[0],
                num_negatives=cfg.negative_samples,
                buffer_sample_size=cfg.negative_sample_from_buffer,
                mult=cfg.neg_sampling_multiplying_factor,
                rows=cfg.train_valid_row_capacity)
        sampler["uniforms"] = shard.click_block(uniforms)
    pool, neg_idx, neg_ids = sample_negatives_pooled_rows(
        all_clicked, stream.buffer_ids, row_session, rows.row_click, **sampler
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
    shard=None,
):
    """One train batch -> (state', metrics).

    ``batch`` is a collated batch on the model's device.  The sampler draws
    from ``state.generator``, or takes ``uniforms`` (click keys [M, NC] with
    compaction, [B, L, NC] without; under a mesh at the global batch's
    shape); the dropout masks always come from ``state.generator``.  After
    the step every parameter's ``.grad`` holds this batch's gradient (under
    a mesh, the global batch's).  Metrics: ``loss``, ``ce_loss``,
    ``reg_loss``, ``sessions``, ``clicks`` and, with a capacity,
    ``dropped_clicks``.
    """
    model, cfg = state.model, state.model.cfg
    stream = state.stream
    with torch.enable_grad():
        with span("nar.train_step.sample"):
            inputs = _train_inputs(model, stream, batch, ace_matrix, metadata,
                                   state.generator, uniforms, shard)
        with span("nar.train_step.forward"):
            forward = model if shard is None else shard.model_call(model)
            out = forward(batch, inputs.aux, inputs.neg_ids, train=True,
                          neg_pool=inputs.pool, neg_pool_idx=inputs.neg_idx,
                          scoring_rows=inputs.scoring_rows, generator=state.generator)
            if shard is None:
                reg = l2_regularization(model, cfg.reg_weight_decay)
                loss = out.ce_loss + reg - out.nov_reg_loss
                local_loss = loss
            else:
                # the L2 term's gradient counts once in the data group's sum
                own_reg, reg = shard.l2(model, cfg.reg_weight_decay)
                local_loss = (out.ce_loss + own_reg - out.nov_reg_loss if shard.counts_l2
                              else out.ce_loss - out.nov_reg_loss)
        with span("nar.train_step.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            local_loss.backward()
    with span("nar.train_step.optimizer"):
        # optax updates every leaf; torch's Adam skips a parameter whose
        # grad is None, so give such a parameter a zero gradient
        for param in model.parameters():
            if param.grad is None:
                param.grad = torch.zeros_like(param)
        if shard is not None:
            shard.sync_grads(model)
        state.optimizer.step()
    ce_loss, dropped = out.ce_loss.detach(), inputs.dropped
    if shard is None:
        sessions, clicks = (batch["session_size"] > 0).sum(), out.loss_mask.sum()
    else:
        sums = [ce_loss, out.nov_reg_loss.detach()] + ([] if dropped is None else [dropped])
        ce_loss, nov, *dropped = shard.data_sum(sums)
        loss = ce_loss + reg - nov
        dropped = dropped[0] if dropped else None
        sessions, clicks = shard.sessions_count, shard.valid_clicks
    metrics = {
        "loss": loss.detach(),
        "ce_loss": ce_loss,
        "reg_loss": reg.detach(),
        "sessions": sessions,
        "clicks": clicks,
    }
    if dropped is not None:
        metrics["dropped_clicks"] = dropped
    with span("nar.train_step.stream"):
        new_stream = update_stream_state(stream, inputs.all_clicked, inputs.all_ts, cfg)
    return state._replace(stream=new_stream, step=state.step + 1), metrics


def _eval_inputs(model, stream, batch, ace_matrix, metadata, generator, uniforms,
                 shard=None):
    """What the model call of an eval step takes besides the batch: the aux
    inputs and the grid sampler's pool and per-click negatives (the final
    label column dropped), with the batch's clicks and their timestamps
    (under a mesh, the global batch's)."""
    cfg = model.cfg
    aux = _aux(stream, ace_matrix, metadata, shard)
    all_clicked, all_ts = _batch_all_clicks(batch if shard is None else shard.batch)
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
        sessions=None if shard is None else shard.sessions,
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
    shard=None,
):
    """One eval batch -> (stream', metrics, fetches).

    ``batch`` is a collated batch (``data.collate``) on the model's device.
    The sampler draws from ``generator``, or takes ``uniforms`` when given
    (for parity with another implementation's draws).  Under
    ``fetch_full_ranking=False`` the fetches hold only the top
    ``metrics_top_n`` predicted ids and no probabilities.  Under a mesh
    (``shard``) the metrics are the global batch's and the fetches the
    rank's rows.
    """
    cfg = model.cfg
    aux, pool, neg_idx, neg_ids, all_clicked, all_ts = _eval_inputs(
        model, stream, batch, ace_matrix, metadata, generator, uniforms, shard
    )
    forward = model if shard is None else shard.model_call(model)
    out = forward(batch, aux, neg_ids, rank=True, neg_pool=pool, neg_pool_idx=neg_idx)

    metrics = device_ranking_metrics(
        out.predicted_ids, batch["label_next_item"], out.loss_mask,
        cfg.metrics_top_n,
    )
    metrics["ce_loss"] = out.ce_loss
    if shard is None:
        metrics["clicks"] = out.loss_mask.sum()
        metrics["sessions"] = (batch["session_size"] > 0).sum()
    else:
        metrics = dict(zip(metrics, shard.data_sum(list(metrics.values()))))
        metrics["clicks"] = shard.valid_clicks
        metrics["sessions"] = shard.sessions_count
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
