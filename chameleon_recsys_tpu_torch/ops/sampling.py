"""Fixed-shape, vectorised negative sampling (the grid sampler).

Port of ``chameleon_recsys_tpu/ops/sampling.py``: ``sample_from_buffer``,
the candidate pool, the per-click selection, ``sample_negatives_pooled`` /
``sample_negatives`` (the grid) and ``sample_negatives_pooled_rows`` (only
the (session, click) rows the train step's compaction selected; one group,
the layout without a mesh).  The semantics are the reference's in-graph sampler:

  1. candidates = the batch's clicks (with repetition, hence popularity
     bias) and a random sample of the recent-clicks buffer, shuffled, the
     first ``mult * K`` kept;
  2. per session, candidates clicked inside the session are excluded (by
     value);
  3. per click, the candidates are shuffled, de-duplicated keeping the first
     occurrence, and the first K kept, padded with the sentinel.

Step 3 draws ONE key ``-log1p(-U) / m`` at the end of each value's segment
of the value-sorted pool (m = the value's count): the ranking of these
Exp(m) keys has the law of the values' first positions in a uniform
shuffle.

Randomness: every draw comes from an explicit ``torch.Generator``; for
parity with the JAX package the three uniform arrays can be passed in
instead (``SamplerUniforms``), since JAX's threefry and torch's Philox never
give the same stream.  The JAX package's ``approx_negative_topk`` maps to
``lax.approx_max_k``, a TPU-only approximation; this port always takes the
exact top-k, which the JAX package's own argument
(``chameleon_recsys_tpu/ops/sampling.py:43-51``: any recall is still a valid
random draw) makes a draw of the same law.

Top-k here is a stable ascending sort of the keys, cut at k: it reproduces
``lax.top_k(-keys, k)`` exactly, ties included (the lower index first), which
``torch.topk`` does not promise.  Article id 0 is never sampled, because
padding shares value 0 (a quirk of the reference kept here).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SamplerUniforms(NamedTuple):
    """The uniform [0, 1) draws of one ``sample_negatives_pooled`` call."""

    buffer: torch.Tensor  # [buffer_size]: shuffle keys of the click buffer
    pool: torch.Tensor  # [B * L + buffer_sample_size]: shuffle keys of the pool
    click: torch.Tensor  # [B, L, NC] (grid) or [M, NC] (rows): selection keys


def _smallest_k(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest keys along the last axis, ascending, ties to the
    lower index: (values, indices), as ``lax.top_k(-keys, k)`` orders them."""
    values, idx = torch.sort(keys, dim=-1, stable=True)
    return values[..., :k], idx[..., :k]


def sample_from_buffer(
    u_buffer: torch.Tensor, buffer_ids: torch.Tensor, sample_size: int
) -> torch.Tensor:
    """Random sample without replacement of the non-zero buffer entries
    (shuffle, take the first ``sample_size``); an under-full buffer gives
    0-padding."""
    keys = torch.where(buffer_ids != 0, u_buffer, torch.inf)
    values, idx = _smallest_k(keys, sample_size)
    return torch.where(torch.isfinite(values), buffer_ids[idx], 0)


def _session_sort(candidates: torch.Tensor):
    """Sort candidates by value and mark segment starts and ends."""
    sorted_vals, perm = torch.sort(candidates, stable=True)
    change = sorted_vals[1:] != sorted_vals[:-1]
    edge = torch.ones(1, dtype=torch.bool, device=candidates.device)
    new_seg = torch.cat([edge, change])
    seg_end = torch.cat([change, edge])
    return perm, sorted_vals, new_seg, seg_end


def _build_candidate_pool(
    u_buffer, u_pool, all_clicked_items, buffer_ids, *,
    num_negatives, buffer_sample_size, mult,
):
    """Batch clicks and a buffer sample -> the value-sorted pool of at most
    NC candidates, the per-session validity (session exclusion) in that
    layout, and the pool with its sentinel row NC (id 0) appended."""
    b, l = all_clicked_items.shape
    nc = min(num_negatives * mult, b * l + buffer_sample_size)

    buffer_sample = sample_from_buffer(u_buffer, buffer_ids, buffer_sample_size)
    pool = torch.cat([
        all_clicked_items.reshape(-1).to(torch.int32),
        buffer_sample.to(torch.int32),
    ])
    pool_keys = torch.where(pool != 0, u_pool, torch.inf)
    values, idx = _smallest_k(pool_keys, nc)
    cand = torch.where(torch.isfinite(values), pool[idx], 0)  # [NC]

    hit = (cand[None, :, None] == all_clicked_items[:, None, :]).any(-1)
    valid = (cand != 0)[None, :] & ~hit  # [B, NC]

    # exported value-sorted, so per-click positions index the pool directly
    perm, sorted_vals, new_seg, seg_end = _session_sort(cand)
    valid_sorted = valid[:, perm]
    pool_ext = torch.cat([sorted_vals, sorted_vals.new_zeros(1)])
    return nc, new_seg, seg_end, valid_sorted, pool_ext


def _per_click_idx(u_click, new_seg, seg_end, valid, num_negatives):
    """[..., NC] uniforms -> [..., K] positions in the value-sorted pool (NC
    where fewer than K candidates are valid); ``valid`` [..., NC] in the
    value-sorted layout broadcasts against ``u_click``."""
    nc = new_seg.shape[0]
    pos = torch.arange(nc, dtype=torch.int32, device=new_seg.device)
    seg_start = torch.cummax(torch.where(new_seg, pos, 0), dim=0).values
    seg_len = (pos - seg_start + 1).to(torch.float32)
    # one Exp(m)-ranked key per segment end; validity is constant within a
    # segment because session exclusion is by value
    key = torch.where(seg_end & valid, -torch.log1p(-u_click) / seg_len, torch.inf)
    values, idx = _smallest_k(key, num_negatives)
    return torch.where(torch.isfinite(values), idx, nc)


def draw_uniforms(
    generator: torch.Generator, b: int, l: int, buffer_size: int, *,
    num_negatives: int, buffer_sample_size: int, mult: int = 20,
    rows: Optional[int] = None,
) -> SamplerUniforms:
    """Draw the uniforms of one sampler call from ``generator``, on its
    device: per click of the [B, L] grid, or per selected row when ``rows``
    (M) is given."""
    nc = min(num_negatives * mult, b * l + buffer_sample_size)
    device = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return SamplerUniforms(
        buffer=uniform(buffer_size),
        pool=uniform(b * l + buffer_sample_size),
        click=uniform(b, l, nc) if rows is None else uniform(rows, nc),
    )


def sample_negatives_pooled(
    all_clicked_items: torch.Tensor,  # [B, L] int32, 0-padded
    buffer_ids: torch.Tensor,  # [buffer_size] int32, newest-first
    *,
    num_negatives: int,
    buffer_sample_size: int,
    mult: int = 20,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[SamplerUniforms] = None,
    sessions: Optional[slice] = None,
):
    """Negatives per (session, click) from a shared candidate pool.

    Every negative is one of at most ``mult * K`` pool items, so per-item
    work can run once per pool row and be gathered per (session, click, k).
    Draws come from ``generator``, or are ``uniforms`` when given.  With
    ``sessions`` (a rank's block under a mesh) the pool is the whole
    batch's and the draws are at the whole batch's shape, but the negatives
    are those of the ``sessions`` rows only.

    Returns:
      pool_ext: int32 [NC+1] value-sorted; row NC is the sentinel (id 0).
      neg_idx:  int64 [B, L, K] indices into pool_ext (NC for padding).
      neg_ids:  int32 [B, L, K] == pool_ext[neg_idx].
    """
    b, l = all_clicked_items.shape
    if uniforms is None:
        if generator is None:
            raise ValueError("sample_negatives_pooled needs a generator or uniforms")
        uniforms = draw_uniforms(
            generator, b, l, buffer_ids.shape[0], num_negatives=num_negatives,
            buffer_sample_size=buffer_sample_size, mult=mult,
        )
    nc, new_seg, seg_end, valid_sorted, pool_ext = _build_candidate_pool(
        uniforms.buffer, uniforms.pool, all_clicked_items, buffer_ids,
        num_negatives=num_negatives, buffer_sample_size=buffer_sample_size,
        mult=mult,
    )
    if tuple(uniforms.click.shape) != (b, l, nc):
        raise ValueError(
            f"click uniforms must be [{b}, {l}, {nc}], got "
            f"{tuple(uniforms.click.shape)}"
        )
    click, clicked = uniforms.click, all_clicked_items
    if sessions is not None:
        click, clicked, valid_sorted = (
            x[sessions] for x in (click, clicked, valid_sorted))
    idx = _per_click_idx(click, new_seg, seg_end, valid_sorted[:, None, :],
                         num_negatives)
    neg_idx = torch.where((clicked != 0)[..., None], idx, nc)
    return pool_ext, neg_idx, pool_ext[neg_idx]


def sample_negatives_pooled_rows(
    all_clicked_items: torch.Tensor,  # [B, L] int32, 0-padded
    buffer_ids: torch.Tensor,  # [buffer_size] int32, newest-first
    row_session: torch.Tensor,  # [M] session index of each selected row
    row_click: torch.Tensor,  # [M] the row's click id (0: a padding row)
    *,
    num_negatives: int,
    buffer_sample_size: int,
    mult: int = 20,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[SamplerUniforms] = None,
):
    """Negatives for the M selected (session, click) rows only, from the same
    shared pool as ``sample_negatives_pooled``: the pool and the session
    exclusion are the grid sampler's, the per-click selection runs M times
    with one [M, NC] array of uniforms.  A row whose click is 0 gets only
    the sentinel.

    Under grouped compaction the JAX sampler (``groups`` > 1) looks each
    row's session up within its group's block of B / G sessions, to keep the
    lookup local to a data shard; on one device that gives
    ``valid_sorted[row_session]`` exactly, so the flat lookup serves every
    ``groups``.

    Returns (pool_ext [NC+1], neg_idx int64 [M, K], neg_ids int32 [M, K]).
    """
    b, l = all_clicked_items.shape
    m = row_session.shape[0]
    if uniforms is None:
        if generator is None:
            raise ValueError(
                "sample_negatives_pooled_rows needs a generator or uniforms"
            )
        uniforms = draw_uniforms(
            generator, b, l, buffer_ids.shape[0], num_negatives=num_negatives,
            buffer_sample_size=buffer_sample_size, mult=mult, rows=m,
        )
    nc, new_seg, seg_end, valid_sorted, pool_ext = _build_candidate_pool(
        uniforms.buffer, uniforms.pool, all_clicked_items, buffer_ids,
        num_negatives=num_negatives, buffer_sample_size=buffer_sample_size,
        mult=mult,
    )
    if tuple(uniforms.click.shape) != (m, nc):
        raise ValueError(
            f"click uniforms must be [{m}, {nc}], got {tuple(uniforms.click.shape)}"
        )
    idx = _per_click_idx(uniforms.click, new_seg, seg_end,
                         valid_sorted[row_session.long()], num_negatives)
    neg_idx = torch.where((row_click != 0)[:, None], idx, nc)
    return pool_ext, neg_idx, pool_ext[neg_idx]


def sample_negatives(
    all_clicked_items: torch.Tensor,
    buffer_ids: torch.Tensor,
    *,
    num_negatives: int,
    buffer_sample_size: int,
    mult: int = 20,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[SamplerUniforms] = None,
) -> torch.Tensor:
    """int32 [B, L, K] negatives per (session, click); the caller drops the
    final column (the last label has no next click)."""
    return sample_negatives_pooled(
        all_clicked_items, buffer_ids, num_negatives=num_negatives,
        buffer_sample_size=buffer_sample_size, mult=mult,
        generator=generator, uniforms=uniforms,
    )[2]
