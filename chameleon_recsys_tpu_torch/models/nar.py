"""NAR (Next-Article Recommendation) model.

Port of ``chameleon_recsys_tpu/models/nar.py::NARModel`` in three cases:
  * serving: candidates scored at one position per session
    (``candidate_positions``);
  * eval: every (session, step) of the grid scored against its negatives
    from a shared candidate pool (``neg_pool`` / ``neg_pool_idx``), with the
    masked cross-entropy and, under ``rank``, the ranked candidates;
  * training (``train=True``) on the same pooled path, over the grid or over
    the (session, step) rows that the train step's compaction selected
    (``scoring_rows``); gradients come from autograd and the kernels'
    ``autograd.Function``s.
With ``use_pallas_scorer`` and three matching layers the negatives go
through the hand-written fused scorer kernels (``ops/kernels/cand_scorer.py``).
Dropout (``keep_prob < 1``) and the dense per-candidate grid path it takes
are not ported.  One forward pass:

  user-context towers | item features (metadata towers + frozen ACE + item
  embedding + recency/novelty against the click buffer's stats)
    -> learned elementwise scale/center (gamma*x + beta)
    -> PreCAR (leaky relu) -> CAR (tanh)              [input / positive / cand]
    -> stacked UGRNN over the session -> FC1(512, leaky) -> FC2(CAR, tanh)
    -> matching MLP on (predicted * candidate) -> temperature softmax over
       [positive | candidates]

bf16 follows the JAX package's explicit casts (f32 parameters cast to the
compute dtype at each use; activations kept in it between ops), not
``torch.autocast``.  Parameter names follow the Flax tree so that
``convert.params_from_flax`` maps one to one.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import (
    ArticleFeaturesSchema,
    NARConfig,
    SECONDS_PER_DAY,
    SessionFeaturesSchema,
    embedding_dim_for_cardinality,
)
from ..ops.embedding import pool_gather
from ..ops.kernels.cand_scorer import cand_score, kernel_takes
from ..ops.normalization import log1p_base, log_base, normalize_values
from ..ops.rnn import StackedUGRNN
from .towers import FeatureTowers, gather_rows

# tf.nn.leaky_relu's default slope, which the reference uses; torch's is 0.01
_LEAKY_ALPHA = 0.2


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, _LEAKY_ALPHA)


def _select_rows(x: torch.Tensor, rows_sel: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> [M, ...]: the selected rows of the flat B*T grid."""
    return x.reshape((-1,) + x.shape[2:])[rows_sel]


class NARAux(NamedTuple):
    """Non-trainable inputs to the forward pass."""

    ace_matrix: torch.Tensor  # [num_items, ace_dim] frozen content embeddings
    metadata: Dict[str, torch.Tensor]  # per-article metadata columns
    recent_pop_norm: torch.Tensor  # [num_items] f32
    buffer_ids: torch.Tensor  # [buffer_size] int32 newest-first


class NAROutputs(NamedTuple):
    items_prob: torch.Tensor  # [B, T, 1+K] f32 ([M, 1+K] with scoring_rows)
    candidate_ids: torch.Tensor  # [B, T, 1+K] / [M, 1+K] (label first)
    loss_mask: torch.Tensor  # [B, T] f32
    ce_loss: torch.Tensor  # scalar
    nov_reg_loss: torch.Tensor  # scalar (0 when disabled)
    predicted_ids: Optional[torch.Tensor]  # [B, T, 1+K] ranked by prob desc
    predicted_probs: Optional[torch.Tensor]  # [B, T, 1+K] sorted probs


class NARModel(nn.Module):
    def __init__(
        self,
        cfg: NARConfig,
        session_schema: SessionFeaturesSchema,
        article_schema: ArticleFeaturesSchema,
        ace_dim: int,
    ):
        super().__init__()
        self.cfg = cfg
        self.session_schema = session_schema
        self.article_schema = article_schema
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.dtype = dt
        feats = cfg.internal_features

        self.ctx_specs = session_schema.context_sequence_features()
        self.user_context_towers = (
            FeatureTowers(self.ctx_specs, cfg.max_cardinality_for_ohe, dtype=dt)
            if self.ctx_specs else None
        )
        user_dim = (
            self.user_context_towers.output_dim if self.ctx_specs else 1
        )
        self.metadata_specs = article_schema.metadata_features()
        self.article_metadata_towers = (
            FeatureTowers(self.metadata_specs, cfg.max_cardinality_for_ohe, dtype=dt)
            if self.metadata_specs else None
        )
        item_dim = (
            self.article_metadata_towers.output_dim if self.metadata_specs else 0
        )
        if feats.article_content_embeddings:
            item_dim += ace_dim
        self.item_clicked_embedding = None
        if feats.item_clicked_embeddings:
            num_items = article_schema.num_items
            emb_dim = embedding_dim_for_cardinality(
                num_items, cfg.item_embedding_const_mult
            )
            self.item_clicked_embedding = nn.Embedding(num_items, emb_dim)
            item_dim += emb_dim
        item_dim += int(feats.recency) + int(feats.novelty)

        feat_dim = user_dim + item_dim
        c = cfg.car_embedding_size
        self.gamma_scale = nn.Parameter(torch.ones(feat_dim))
        self.beta_center = nn.Parameter(torch.zeros(feat_dim))
        self.PreCAR_kernel = nn.Parameter(torch.empty(feat_dim, c))
        self.PreCAR_bias = nn.Parameter(torch.zeros(c))
        self.CAR_kernel = nn.Parameter(torch.empty(c, c))
        self.CAR_bias = nn.Parameter(torch.zeros(c))

        self.rnn = StackedUGRNN(
            c, cfg.rnn_units, cfg.rnn_num_layers, dtype=dt,
            use_kernel=cfg.use_pallas_rnn,
        )
        self.session_FC1 = nn.Linear(cfg.rnn_units, 512)
        self.session_FC2 = nn.Linear(512, c)

        self.matching_names = []
        m_in = c
        for i, units in enumerate(cfg.matching_layer_sizes):
            name = f"matching_{i + 1}"
            self.register_parameter(
                f"{name}_kernel", nn.Parameter(torch.empty(m_in, units))
            )
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(units)))
            self.matching_names.append(name)
            m_in = units
        self.matching_out_kernel = nn.Parameter(torch.empty(m_in, 1))
        self.matching_out_bias = nn.Parameter(torch.zeros(1))

    # -- initialisation ----------------------------------------------------
    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from ``generator``: He
        (truncated normal, fan_in) for PreCAR, FC1 and the matching layers,
        Glorot uniform for CAR, FC2, the RNN and the embeddings, LeCun
        uniform for the matching output, zeros for biases and beta, ones for
        gamma.  Equal in distribution to Flax's draws, not in value."""

        def he(p, fan_in):
            # Flax divides the std by the std of a unit normal cut at +-2
            std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)

        def uniform(p, limit):
            nn.init.uniform_(p, -limit, limit, generator=generator)

        def glorot(p):
            uniform(p, math.sqrt(6.0 / (p.shape[0] + p.shape[1])))

        for name, p in self.named_parameters():
            if name == "gamma_scale":
                p.fill_(1.0)
            elif name.endswith("bias") or name == "beta_center":
                p.zero_()
            elif name == "PreCAR_kernel" or name.startswith("matching_") and (
                name != "matching_out_kernel"
            ):
                he(p, p.shape[0])  # [in, out]
            elif name == "session_FC1.weight":
                he(p, p.shape[1])  # nn.Linear: [out, in]
            elif name == "matching_out_kernel":
                uniform(p, math.sqrt(3.0 / p.shape[0]))
            else:
                glorot(p)

    # -- dynamic features ----------------------------------------------------
    def _buffer_stat_ids(self, aux: NARAux):
        ids = aux.buffer_ids[: self.cfg.recent_clicks_for_normalization]
        return ids, ids != 0

    def _normalize_with_fallback(self, values, item_ids, stat_values, stat_mask):
        """Normalize against the buffer's stats, or against the call's own
        values when the buffer is empty (the reference's first-batch
        fallback), with fixed shapes: both stat sources, one masked out."""
        buffer_empty = ~stat_mask.any()
        batch_mask = (item_ids != 0).reshape(-1) & buffer_empty
        stats_values = torch.cat([stat_values, values.reshape(-1)])
        stats_mask = torch.cat([stat_mask, batch_mask])
        return normalize_values(values, stats_values, stats_mask)[..., None]

    def _recency_feature(self, item_ids, ref_ts, aux: NARAux):
        """Normalized smoothed days since publishing."""
        base = self.cfg.elapsed_days_smooth_log_base
        created_col = aux.metadata["created_at_ts"]
        created = gather_rows(created_col, item_ids).float()
        elapsed = torch.relu((ref_ts.float() - created) / SECONDS_PER_DAY)
        smoothed = log1p_base(elapsed, base)

        stat_ids, stat_mask = self._buffer_stat_ids(aux)
        stat_created = gather_rows(created_col, stat_ids).float()
        max_batch_ts = ref_ts.max().float()
        stat_elapsed = torch.relu((max_batch_ts - stat_created) / SECONDS_PER_DAY)
        stat_smoothed = log1p_base(stat_elapsed, base)
        return self._normalize_with_fallback(
            smoothed, item_ids, stat_smoothed, stat_mask
        )

    def _novelty_feature(self, item_ids, aux: NARAux):
        """Standardized popularity novelty -log2(pop_norm)."""
        base = self.cfg.popularity_smooth_log_base
        novelty = -log_base(gather_rows(aux.recent_pop_norm, item_ids), base)
        stat_ids, stat_mask = self._buffer_stat_ids(aux)
        stat_novelty = -log_base(gather_rows(aux.recent_pop_norm, stat_ids), base)
        return self._normalize_with_fallback(
            novelty, item_ids, stat_novelty, stat_mask
        )

    # -- item features -------------------------------------------------------
    def _shared_item_feats(self, item_ids, aux: NARAux):
        """Parameter-bearing per-item features: metadata towers, ACE, the
        trainable id embedding."""
        feats = []
        if self.article_metadata_towers is not None:
            feats.append(self.article_metadata_towers({
                spec.name: gather_rows(aux.metadata[spec.name], item_ids)
                for spec in self.metadata_specs
            }))
        if self.cfg.internal_features.article_content_embeddings:
            feats.append(gather_rows(aux.ace_matrix, item_ids).to(self.dtype))
        if self.item_clicked_embedding is not None:
            feats.append(
                gather_rows(self.item_clicked_embedding.weight, item_ids).to(
                    self.dtype
                )
            )
        return feats

    def _dynamic_item_feats(self, item_ids, ref_ts, aux: NARAux):
        """Parameter-free recency/novelty; each call normalizes over its own
        ids when the buffer is empty."""
        feats = []
        if self.cfg.internal_features.recency:
            feats.append(self._recency_feature(item_ids, ref_ts, aux).to(self.dtype))
        if self.cfg.internal_features.novelty:
            feats.append(self._novelty_feature(item_ids, aux).to(self.dtype))
        return feats

    # -- towers ----------------------------------------------------------------
    def _scale_center(self, x):
        return x * self.gamma_scale.to(x.dtype) + self.beta_center.to(x.dtype)

    def _car_tower(self, x):
        dt = self.dtype
        pre = _leaky(x @ self.PreCAR_kernel.to(dt) + self.PreCAR_bias.to(dt))
        return torch.tanh(pre @ self.CAR_kernel.to(dt) + self.CAR_bias.to(dt))

    def _dense(self, layer: nn.Linear, x):
        dt = self.dtype
        return x @ layer.weight.to(dt).T + layer.bias.to(dt)

    def _match_score(self, x):
        dt = self.dtype
        for name in self.matching_names:
            kernel = getattr(self, f"{name}_kernel").to(dt)
            bias = getattr(self, f"{name}_bias").to(dt)
            x = _leaky(x @ kernel + bias)
        return (
            x @ self.matching_out_kernel.to(dt) + self.matching_out_bias.to(dt)
        )[..., 0]

    def _item_features(self, item_ids, ref_ts, aux: NARAux):
        return torch.cat(
            self._shared_item_feats(item_ids, aux)
            + self._dynamic_item_feats(item_ids, ref_ts, aux),
            dim=-1,
        )

    # -- forward -----------------------------------------------------------------
    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        aux: NARAux,
        neg_items: torch.Tensor,  # [B, 1, K] serving / [B, T, K] grid
        *,
        candidate_positions: Optional[torch.Tensor] = None,  # [B]
        train: bool = False,
        rank: bool = False,
        neg_pool: Optional[torch.Tensor] = None,  # [NC+1] shared pool
        neg_pool_idx: Optional[torch.Tensor] = None,  # [B, T, K] / [M, K]
        scoring_rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """Serving (``candidate_positions`` given): the softmax over
        [label slot | K candidates] at each session's candidate position,
        [B, 1, 1+K] f32.  The grid with a shared candidate pool (eval, or
        training): ``NAROutputs`` over every (session, step), or with
        ``scoring_rows`` = (rows_sel [M] flat indices into the B*T grid,
        row_mask [M] f32) over those M rows only, ``neg_items`` and
        ``neg_pool_idx`` then [M, K].  ``train`` changes nothing at
        ``keep_prob`` 1 (dropout of rate 0 is the identity); autograd records
        whenever grad is enabled."""
        if train and self.cfg.keep_prob < 1.0:
            raise NotImplementedError(
                "dropout (keep_prob < 1) and the dense train path it takes "
                "are not ported"
            )
        if candidate_positions is not None:
            if rank or neg_pool is not None or scoring_rows is not None:
                raise NotImplementedError(
                    "serving takes neither rank, neg_pool nor scoring_rows"
                )
            return self._serve(batch, aux, neg_items, candidate_positions)
        if scoring_rows is not None and rank:
            raise ValueError(
                "scoring_rows supports the train path only (rank=False, no "
                "candidate_positions)"
            )
        if neg_pool is None or neg_pool_idx is None:
            raise NotImplementedError(
                "the grid path needs neg_pool and neg_pool_idx: the dense "
                "per-candidate grid path is not ported"
            )
        return self._pooled(batch, aux, neg_items, neg_pool, neg_pool_idx, rank,
                            scoring_rows)

    def _encode(self, batch, aux: NARAux):
        """User context, the positive CAR rows and the session encoder's
        predicted embedding, all [B, T, ...], with the valid-step mask."""
        dt = self.dtype
        item_clicked = batch["item_clicked"]  # [B, T]
        next_item_label = batch["label_next_item"]  # [B, T]
        b, t = item_clicked.shape
        device = item_clicked.device

        seq_lengths = batch["session_size"].long() - 1
        mask = torch.arange(t, device=device)[None, :] < seq_lengths[:, None]
        event_ts = batch["event_timestamp"]
        max_event_ts = event_ts.max()

        if self.user_context_towers is not None:
            user_ctx = self.user_context_towers(
                {s.name: batch[s.name] for s in self.ctx_specs}
            )
        else:
            user_ctx = torch.zeros((b, t, 1), dtype=dt, device=device)

        # param-bearing item features in ONE pass over input | label ids
        bt = b * t
        ids_all = torch.cat([item_clicked.reshape(-1), next_item_label.reshape(-1)])
        shared_all = self._shared_item_feats(ids_all, aux)
        shared_all = torch.cat(shared_all, dim=-1) if shared_all else None

        def shared_slice(lo, hi):
            if shared_all is None:
                return []
            return [shared_all[lo:hi].reshape(b, t, -1)]

        input_item_feats = torch.cat(
            shared_slice(0, bt)
            + self._dynamic_item_feats(item_clicked, event_ts, aux),
            dim=-1,
        )
        pos_item_feats = torch.cat(
            shared_slice(bt, 2 * bt)
            + self._dynamic_item_feats(next_item_label, max_event_ts, aux),
            dim=-1,
        )
        stacked = self._scale_center(torch.stack([
            torch.cat([user_ctx, input_item_feats], -1),
            torch.cat([user_ctx, pos_item_feats], -1),
        ]))
        stacked_car = self._car_tower(stacked)  # [2, B, T, C]
        input_car, pos_car = stacked_car[0], stacked_car[1]

        rnn_out = self.rnn(input_car, mask)
        h = _leaky(self._dense(self.session_FC1, rnn_out))
        predicted_emb = torch.tanh(self._dense(self.session_FC2, h))  # [B, T, C]
        return user_ctx, pos_car, predicted_emb, mask, max_event_ts

    def _serve(self, batch, aux, neg_items, candidate_positions):
        """Candidates at one position per session (the dense candidate
        path): [B, 1, 1+K] f32."""
        cfg = self.cfg
        user_ctx, pos_car, predicted_emb, _, max_event_ts = self._encode(batch, aux)
        b, k = user_ctx.shape[0], neg_items.shape[-1]
        rows = torch.arange(b, device=user_ctx.device)
        pos_idx = candidate_positions.long()
        ctx_for_neg = user_ctx[rows, pos_idx][:, None]  # [B, 1, F_u]
        neg_item_feats = self._item_features(neg_items, max_event_ts, aux)
        user_ctx_tiled = ctx_for_neg[:, :, None, :].expand(b, 1, k, -1)
        neg_car = self._car_tower(
            self._scale_center(torch.cat([user_ctx_tiled, neg_item_feats], -1))
        )  # [B, 1, K, C]

        pred_for_neg = predicted_emb[rows, pos_idx][:, None]  # [B, 1, C]
        pos_for_neg = pos_car[rows, pos_idx][:, None]
        # the label slot rides the candidate axis and enters the softmax
        cand_car = torch.cat([pos_for_neg[:, :, None, :], neg_car], dim=2)
        all_scores = self._match_score(cand_car * pred_for_neg[:, :, None, :])
        scores = all_scores.float() / cfg.softmax_temperature
        return torch.softmax(scores, dim=-1)

    def _pre_split(self, user_ctx, neg_pool, max_event_ts, aux: NARAux):
        """The PreCAR projection split in three: the user half [B, T, C], the
        item half once per pool row [NC+1, C], and the constant
        beta @ W_pre + b_pre [C]."""
        dt = self.dtype
        user_dim = user_ctx.shape[-1]
        pool_feats = self._item_features(neg_pool, max_event_ts, aux)  # [NC+1, F_i]
        gamma = self.gamma_scale.to(dt)
        pre_kernel = self.PreCAR_kernel.to(dt)
        u_pre = (user_ctx * gamma[:user_dim]) @ pre_kernel[:user_dim]
        i_pre = (pool_feats * gamma[user_dim:]) @ pre_kernel[user_dim:]
        const = self.beta_center.to(dt) @ pre_kernel + self.PreCAR_bias.to(dt)
        return u_pre, i_pre, const

    def _scorer_operands(self, u_pre, i_pre, const, pred, neg_pool_idx):
        """The fused scorer's operands in its call order: the gathered item
        rows [R*K, C], u_pre + const and pred [R, C] (R = B*T, or the M
        compacted rows), the CAR and matching weights and w4 [M3].  Nothing
        [R*K, C]-shaped but the gathered rows is materialised."""
        dt = self.dtype
        c = pred.shape[-1]
        matching = []
        for name in self.matching_names:
            matching += [getattr(self, f"{name}_kernel").to(dt),
                         getattr(self, f"{name}_bias").to(dt)]
        return (
            pool_gather(i_pre, neg_pool_idx.reshape(-1)),
            (u_pre + const).reshape(-1, c),
            pred.reshape(-1, c),
            self.CAR_kernel.to(dt), self.CAR_bias.to(dt), *matching,
            self.matching_out_kernel.to(dt)[:, 0].contiguous(),
        )

    def scorer_operands(self, batch, aux: NARAux, neg_pool, neg_pool_idx,
                        scoring_rows=None):
        """The fused scorer kernel's operands (without ``alpha``) for one
        batch, as the pooled path passes them (over the grid, or over the
        ``scoring_rows`` selection): for holding the kernels against their
        plain twins at the model's own shapes and values."""
        user_ctx, _, pred, _, max_event_ts = self._encode(batch, aux)
        if scoring_rows is not None:
            user_ctx, pred = (_select_rows(x, scoring_rows[0]) for x in (user_ctx, pred))
        return self._scorer_operands(
            *self._pre_split(user_ctx, neg_pool, max_event_ts, aux),
            pred, neg_pool_idx,
        )

    def _pooled(self, batch, aux, neg_items, neg_pool, neg_pool_idx, rank,
                scoring_rows=None):
        """Every (session, step), or the ``scoring_rows`` selection of them,
        scored against its K negatives from the shared pool: per-item
        features and the item half of the PreCAR projection run once per
        pool row, not per (row, k)."""
        cfg, dt = self.cfg, self.dtype
        user_ctx, pos_car, pred, mask, max_event_ts = self._encode(batch, aux)
        b, t = mask.shape
        k = neg_items.shape[-1]
        loss_mask = mask.to(torch.float32)
        labels = batch["label_next_item"]
        ce_mask = loss_mask
        if scoring_rows is not None:
            rows_sel, ce_mask = scoring_rows
            user_ctx, pos_car, pred, labels = (
                _select_rows(x, rows_sel) for x in (user_ctx, pos_car, pred, labels)
            )
        u_pre, i_pre, const = self._pre_split(user_ctx, neg_pool, max_event_ts, aux)

        # As the JAX package's gate, the fused branch only for shapes its
        # kernels take: here the card's widths (``kernel_takes``, decided from
        # the shapes alone, the same on the CPU; with grad on, the backward's
        # too).  The JAX package also asks the row count to be a multiple of
        # its 8-row tile, a Mosaic limit; the CUDA kernels take any row count.
        if (cfg.use_pallas_scorer and len(cfg.matching_layer_sizes) == 3
                and kernel_takes(pred.shape[-1], *cfg.matching_layer_sizes, dt,
                                 train=torch.is_grad_enabled())):
            pos_score = self._match_score(pos_car * pred)  # [B, T] / [M]
            # one kernel for the gathered rows' PreCAR + CAR + matching MLP
            neg_score = cand_score(
                *self._scorer_operands(u_pre, i_pre, const, pred, neg_pool_idx),
                _LEAKY_ALPHA,
            ) + self.matching_out_bias.to(dt)[0].float()
            neg_score = neg_score.reshape(pred.shape[:-1] + (k,))
        else:
            car_w, car_b = self.CAR_kernel.to(dt), self.CAR_bias.to(dt)
            i_rows = pool_gather(i_pre, neg_pool_idx)  # [B, T, K, C] / [M, K, C]
            pre_neg = _leaky(u_pre[..., None, :] + i_rows + const)
            neg_car = torch.tanh(pre_neg @ car_w + car_b)
            # the positive rides the candidate axis: one matching MLP pass
            cand_car = torch.cat([pos_car[..., None, :], neg_car], dim=-2)
            all_scores = self._match_score(cand_car * pred[..., None, :])
            pos_score, neg_score = all_scores[..., 0], all_scores[..., 1:]

        scores = torch.cat([pos_score[..., None].float(), neg_score.float()], -1)
        items_prob = torch.softmax(scores / cfg.softmax_temperature, dim=-1)

        # masked XE over the scored rows; the denominator is the whole
        # batch's valid-click count, so with every valid row selected the
        # compacted loss is the grid's
        denom = torch.clamp_min(loss_mask.sum(), 1.0)
        ce_loss = -(torch.log(items_prob[..., 0] + 1e-24) * ce_mask).sum() / denom

        if cfg.novelty_reg_factor > 0.0:
            neg_prob = torch.softmax(
                neg_score.float() / cfg.softmax_temperature, dim=-1
            )
            neg_novelty = -log_base(
                gather_rows(aux.recent_pop_norm, neg_items),
                cfg.popularity_smooth_log_base,
            )
            masked_nov = cfg.novelty_reg_factor * (
                neg_prob * neg_novelty * ce_mask[..., None]
            ).sum(-1)
            nov_reg_loss = masked_nov.sum() / denom
        else:
            nov_reg_loss = torch.zeros((), device=items_prob.device)

        candidate_ids = torch.cat([labels[..., None], neg_items.to(labels.dtype)], -1)
        predicted_ids = predicted_probs = None
        if rank:
            # stable: ties (padded negatives share the sentinel row) keep the
            # lower index first, as lax.top_k orders them
            predicted_probs, order = torch.sort(
                items_prob, dim=-1, descending=True, stable=True
            )
            predicted_ids = torch.gather(candidate_ids, -1, order)
        return NAROutputs(
            items_prob=items_prob,
            candidate_ids=candidate_ids,
            loss_mask=loss_mask,
            ce_loss=ce_loss,
            nov_reg_loss=nov_reg_loss,
            predicted_ids=predicted_ids,
            predicted_probs=predicted_probs,
        )
