"""Device-resident streaming click state.

Port of ``chameleon_recsys_tpu/state/stream_state.py``, with the same
semantics:
  * the buffer is newest-first (article_id, ts), compacted, zero-padded at
    the end;
  * entries older than ``recent_clicks_buffer_hours`` before the batch's
    minimum valid click timestamp are dropped, then the buffer is truncated
    to ``recent_clicks_buffer_max_size``;
  * recent popularity is recounted from the whole buffer each update and
    normalized as ``max(count / (total + 1), 1/recent_clicks_for_normalization)``;
  * global popularity accumulates per batch.
Ids at or above ``num_items`` stay in the buffer but are left out of the
counts, as the JAX scatter's ``mode="drop"`` leaves them out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import NARConfig, SECONDS_PER_HOUR

_INT32_MAX = 2**31 - 1


class StreamState(NamedTuple):
    buffer_ids: torch.Tensor  # [buffer_size] int32, newest-first, 0-padded
    buffer_ts: torch.Tensor  # [buffer_size] int32 seconds
    recent_pop: torch.Tensor  # [num_items] int32 recent click counts
    recent_pop_norm: torch.Tensor  # [num_items] f32 normalized recent popularity
    global_pop: torch.Tensor  # [num_items] int32 all-time click counts
    current_step: torch.Tensor  # [] int32


def init_stream_state(
    cfg: NARConfig, num_items: int, device="cuda"
) -> StreamState:
    size = cfg.recent_clicks_buffer_max_size
    min_norm_pop = 1.0 / cfg.recent_clicks_for_normalization

    def zeros(n):
        return torch.zeros(n, dtype=torch.int32, device=device)

    return StreamState(
        buffer_ids=zeros(size),
        buffer_ts=zeros(size),
        recent_pop=zeros(num_items),
        recent_pop_norm=torch.full(
            (num_items,), min_norm_pop, dtype=torch.float32, device=device
        ),
        global_pop=zeros(num_items),
        current_step=zeros(()),
    )


def _compact_front(ids, ts, valid):
    """Stably move valid entries to the front, zeroing the rest: each valid
    entry's destination is its rank among valids (a cumsum), invalid ones go
    to a spill slot past the end."""
    n = ids.shape[0]
    dest = torch.where(valid, torch.cumsum(valid, 0) - 1, n)
    out_ids = ids.new_zeros(n + 1).scatter_(0, dest, ids)
    out_ts = ts.new_zeros(n + 1).scatter_(0, dest, ts)
    return out_ids[:n], out_ts[:n]


def _count_ids(ids: torch.Tensor, weights: torch.Tensor, num_items: int):
    """int32 histogram of ``ids`` weighted by ``weights``; out-of-range ids
    are dropped (index_add_ would raise on them) and id 0 is zeroed (by a
    fill of the view: assigning a Python number through ``__setitem__``
    copies it from the host and synchronises on the card)."""
    in_range = (ids >= 0) & (ids < num_items)
    counts = torch.zeros(num_items, dtype=torch.int32, device=ids.device)
    counts.index_add_(
        0, torch.where(in_range, ids, 0).long(),
        torch.where(in_range, weights, 0).to(torch.int32),
    )
    counts[0].zero_()
    return counts


def update_stream_state(
    state: StreamState,
    clicked_ids: torch.Tensor,  # [B, L] int32 clicks in order, 0-padded
    clicked_ts: torch.Tensor,  # [B, L] int32 seconds
    cfg: NARConfig,
) -> StreamState:
    """Fold one batch of clicks into the state; returns a new state."""
    ids_flat = clicked_ids.reshape(-1).to(torch.int32)
    ts_flat = clicked_ts.reshape(-1).to(torch.int32)
    valid = ids_flat != 0

    # newest-first: later clicks of the flattened batch come first
    ids_rev = ids_flat.flip(0)
    ts_rev = ts_flat.flip(0)
    valid_rev = valid.flip(0)

    min_ts_batch = torch.where(valid_rev, ts_rev, _INT32_MAX).min()
    window = int(round(cfg.recent_clicks_buffer_hours * SECONDS_PER_HOUR))
    threshold = min_ts_batch - window

    keep_old = (state.buffer_ids != 0) & (state.buffer_ts >= threshold)
    cat_ids, cat_ts = _compact_front(
        torch.cat([ids_rev, state.buffer_ids]),
        torch.cat([ts_rev, state.buffer_ts]),
        torch.cat([valid_rev, keep_old]),
    )
    size = cfg.recent_clicks_buffer_max_size
    new_buffer_ids = cat_ids[:size]
    new_buffer_ts = cat_ts[:size]

    num_items = state.recent_pop.shape[0]
    recent_pop = _count_ids(new_buffer_ids, new_buffer_ids != 0, num_items)
    total = recent_pop.sum().to(torch.float32)
    recent_pop_norm = torch.clamp_min(
        recent_pop.to(torch.float32) / (total + 1.0),
        1.0 / cfg.recent_clicks_for_normalization,
    )
    global_pop = state.global_pop + _count_ids(ids_flat, valid, num_items)

    return StreamState(
        buffer_ids=new_buffer_ids,
        buffer_ts=new_buffer_ts,
        recent_pop=recent_pop,
        recent_pop_norm=recent_pop_norm,
        global_pop=global_pop,
        current_step=state.current_step + 1,
    )
