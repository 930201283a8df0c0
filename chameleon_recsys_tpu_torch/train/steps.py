"""The NAR eval step.

Port of ``chameleon_recsys_tpu/train/steps.py::eval_step_fn`` (built by
``build_nar_train``): sample ``eval_negative_samples`` negatives per click
from the grid sampler, run the model over the whole [B, T] grid with the
shared candidate pool and ``rank=True``, sum the in-graph ranking metrics,
and fold the batch's clicks into the streaming state (eval updates the
stream too; the temporal protocol snapshots and restores it around an eval
hour).  The train step, its optimizer state and ``NARTrainState`` are not
ported; a ``torch.Generator`` stands in for the JAX state's ``rng``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..models.nar import NARAux, NARModel
from ..ops.sampling import SamplerUniforms, sample_negatives_pooled
from ..state.stream_state import StreamState, update_stream_state


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


def _eval_inputs(model, stream, batch, ace_matrix, metadata, generator, uniforms):
    """What the model call of an eval step takes besides the batch: the aux
    inputs and the grid sampler's pool and per-click negatives (the final
    label column dropped), with the batch's clicks and their timestamps."""
    cfg = model.cfg
    aux = NARAux(
        ace_matrix=ace_matrix,
        metadata=dict(metadata),
        recent_pop_norm=stream.recent_pop_norm,
        buffer_ids=stream.buffer_ids,
    )
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
