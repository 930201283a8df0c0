"""CHAMELEON's eval metric set folded on the device, a batch at a time.

``MetricFold`` computes, for one eval batch, the sum and the count of every
metric that ``evaluation.py::create_eval_metrics`` builds, with the
semantics that ``streaming.py`` states: a click counts where its label is
not 0; HR, MRR and NDCG over the top n; ESI-R and ESI-RR over
``range(n-1)``, the last ranked item left out; EILD-R over all j != i with
the relative-rank discount; EILD-RR over j > i with relevance 1 or
``eval_negative_sample_relevance``; HitRateBySessionPosition's matches,
clicks and label popularity by position; ItemCoverage as two bitmaps.

It is plain tensor code over the batch's whole [B, T] grid, masked by the
valid clicks, so the eval step's CUDA graph holds it
(``train/steps.py::eval_step``, ``train/eval_graphs.py``).  Whatever the
host computes in float64 is float64 here: the cosine distances, from a
normalised float64 copy of the ACE matrix made once per matrix
(``normalized``, as ``streaming.py::_normalized_embeddings`` does), and
every sum; the novelty's ``-log2`` of the float32 popularity is float32,
as on the host.  Reductions run in a fixed order and the bitmaps are set
by writes of one value, so two identical hours give the same bits.

The step returns ``metric_sums``, one float64 vector a batch (``SCALARS``,
then by position the matches, the clicks and the label popularity, [T]
each, where ``by_position``), and sets the batch's ids in the fold's own
ItemCoverage bitmaps in place.  The harness reseeds the bitmaps at the
start of an hour (``seed_coverage``), adds the vectors into the host metric
objects (``add_batch_sums``) and counts the bitmaps' bits once, at the
hour's end (``coverage_counts``, ``add_coverage_counts``);
``compute_metrics_results`` reads them as it reads the host suite's.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .streaming import (
    ContentExpectedRankRelativeRelevanceSensitiveIntraListDiversity,
    ContentExpectedRankRelativeSensitiveIntraListDiversity,
    ExpectedRankRelevanceSensitiveNovelty,
    ExpectedRankSensitiveNovelty,
    HitRate,
    HitRateBySessionPosition,
    ItemCoverage,
    MRR,
    NDCG,
    StreamingMetric,
)

# the batch's scalars, in the order of the packed vector; ``list_clicks``
# counts the clicks of the list metrics (ESI, EILD), which need n >= 2
SCALARS = ("hit_matches", "clicks", "mrr", "ndcg", "esi_r", "esi_rr", "eild_r",
           "eild_rr", "list_clicks")
SUMS = "metric_sums"

# the metric each scalar sum goes to, with the scalar that counts it
_MEANS = {
    MRR.name: ("mrr", "clicks"),
    NDCG.name: ("ndcg", "clicks"),
    ExpectedRankSensitiveNovelty.name: ("esi_r", "list_clicks"),
    ExpectedRankRelevanceSensitiveNovelty.name: ("esi_rr", "list_clicks"),
    ContentExpectedRankRelativeSensitiveIntraListDiversity.name: ("eild_r", "list_clicks"),
    ContentExpectedRankRelativeRelevanceSensitiveIntraListDiversity.name:
        ("eild_rr", "list_clicks"),
}


def _discount(k: torch.Tensor) -> torch.Tensor:
    """1/log2(k+2) in float64 (``streaming.py::log_rank_discount``)."""
    return 1.0 / torch.log2(k.to(torch.float64) + 2.0)


class MetricFold:
    """The eval metric set of ``create_eval_metrics(top_n,
    negative_relevance, by_position, ...)``, folded a batch at a time."""

    def __init__(self, top_n: int, negative_relevance: float, by_position: bool):
        self.top_n = top_n
        self.negative_relevance = float(negative_relevance)
        self.by_position = by_position
        self._normalized = None  # (matrix, its version, the normalised copy)
        self.coverage = None  # ItemCoverage's (recommended, clicked) bitmaps

    def normalized(self, ace_matrix: torch.Tensor) -> torch.Tensor:
        """The ACE rows over their float64 norms (zero rows stay zero),
        made again only when the matrix is another or was written."""
        held = self._normalized
        version = ace_matrix._version
        if held is None or held[0] is not ace_matrix or held[1] != version:
            self._normalized = None  # let the old copy go first
            m = ace_matrix.to(torch.float64)
            norms = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
            held = self._normalized = (ace_matrix, version,
                                       torch.where(norms > 0, m / norms, 0.0))
        return held[2]

    def seed_coverage(self, buffer_ids: torch.Tensor, num_items: int) -> None:
        """Reseed ItemCoverage's bitmaps in place for an hour: over the ids
        [0, num_items), and a last slot that takes the ids of no valid
        click; none recommended, the clicked ones the buffer's ids, zeros
        included, as ItemCoverage seeds its set.  They are made once per
        item count, so a graph that sets them serves every hour."""
        if self.coverage is None or self.coverage[0].shape[0] != num_items + 1:
            self.coverage = tuple(torch.empty(num_items + 1, dtype=torch.bool,
                                              device=buffer_ids.device) for _ in range(2))
        recommended, clicked = self.coverage
        recommended.zero_()
        clicked.zero_()
        clicked.index_fill_(0, buffer_ids.long(), True)

    def coverage_counts(self) -> Tuple[int, int]:
        """The recommended and the clicked ids the bitmaps hold (one fetch)."""
        counts = torch.stack([bits[:-1].sum() for bits in self.coverage]).cpu()
        return int(counts[0]), int(counts[1])

    def __call__(self, predicted_ids, labels, pop_norm, clicked,
                 ace_matrix) -> Dict[str, torch.Tensor]:
        """One batch: ``predicted_ids`` [B, T, >= top_n] ranked, the next
        clicks ``labels`` [B, T], the stream's ``recent_pop_norm`` before
        the batch's update, the batch's ``clicked`` ids [B, T] and the ACE
        matrix -> {``SUMS``: the packed vector}; the batch's ids are set in
        the bitmaps (seeded by ``seed_coverage``)."""
        f64 = torch.float64
        top = predicted_ids[..., : self.top_n].long()
        labels = labels.long()
        n = top.shape[-1]
        valid = labels != 0
        hits = top == labels[..., None]
        found = hits.any(-1) & valid
        first = hits.to(torch.int32).argmax(-1).to(f64)  # the first hit
        clicks = valid.sum().to(f64)
        sums = {
            "hit_matches": found.sum().to(f64),
            "clicks": clicks,
            "mrr": torch.where(found, 1.0 / (1.0 + first), 0.0).sum(),
            "ndcg": torch.where(found, 1.0 / torch.log2(first + 2.0), 0.0).sum(),
        }
        zero = torch.zeros((), dtype=f64, device=top.device)
        if n < 2:  # the list metrics take no click
            sums.update(esi_r=zero, esi_rr=zero, eild_r=zero, eild_rr=zero,
                        list_clicks=zero)
        else:
            sums.update(self._lists(top, labels, valid, pop_norm, ace_matrix))
            sums["list_clicks"] = clicks
        parts = [torch.stack([sums[name] for name in SCALARS])]
        if self.by_position:
            label_pop = pop_norm[labels].to(f64)
            parts += [found.sum(0).to(f64), valid.sum(0).to(f64),
                      torch.where(valid, label_pop, 0.0).sum(0)]
        recommended, seen = self.coverage
        trash = recommended.shape[0] - 1
        shown = torch.where(valid[..., None], top, trash).reshape(-1)
        batch_clicks = torch.cat([labels.reshape(-1), clicked.long().reshape(-1)])
        batch_clicks = torch.where(batch_clicks != 0, batch_clicks, trash)
        recommended.index_fill_(0, shown, True)
        seen.index_fill_(0, batch_clicks, True)
        return {SUMS: torch.cat(parts)}

    def _lists(self, top, labels, valid, pop_norm, ace_matrix) -> Dict[str, torch.Tensor]:
        """ESI-R, ESI-RR, EILD-R and EILD-RR summed over the valid clicks."""
        f64 = torch.float64
        n = top.shape[-1]
        steps = torch.arange(n, device=top.device)
        disc = _discount(steps[: n - 1])  # [n-1]
        negative = torch.full(top.shape, self.negative_relevance, dtype=f64,
                              device=top.device)
        relevant = torch.where(top == labels[..., None], 1.0, negative)  # [B, T, n]

        def total(per_click):
            return torch.where(valid, per_click, 0.0).sum()

        # ESI: the novelty of the top n-1, rank-discounted
        novelty = -torch.log2(pop_norm[top[..., : n - 1]])  # float32, as on the host
        weighted = novelty.to(f64) * disc
        esi_r = weighted.sum(-1) / disc.sum()
        esi_rr = (weighted * relevant[..., : n - 1]).sum(-1) / disc.sum()

        # EILD: halved cosine distances of each list's pairs
        emb = self.normalized(ace_matrix)[top.reshape(-1, n)]  # [B*T, n, D]
        dists = (1.0 - torch.bmm(emb, emb.transpose(1, 2))) / 2.0  # [B*T, n, n]
        dists = dists.reshape(*top.shape, n)
        i, j = steps[:, None], steps[None, :]
        pair = _discount((j - i - 1).clamp_min(0))  # [n, n]
        w_r = torch.where(i == j, 0.0, pair)
        eild_r = (((dists * w_r).sum(-1) / w_r.sum(1))[..., : n - 1] * disc).sum(-1)
        w_rr = torch.where(j > i, pair, 0.0) * relevant[..., None, :]  # [B, T, n, n]
        num, den = (dists * w_rr).sum(-1), w_rr.sum(-1)
        avg = torch.where(den > 0, num / den, 0.0)
        eild_rr = (avg[..., : n - 1] * disc * relevant[..., : n - 1]).sum(-1)
        return {"esi_r": total(esi_r), "esi_rr": total(esi_rr),
                "eild_r": total(eild_r / disc.sum()), "eild_rr": total(eild_rr / disc.sum())}


def add_batch_sums(streaming_metrics: Sequence[StreamingMetric], sums: np.ndarray) -> None:
    """Add one batch's packed vector into the metric objects of
    ``create_eval_metrics`` (ItemCoverage takes its counts once an hour)."""
    scalars = dict(zip(SCALARS, sums[: len(SCALARS)].tolist()))
    for metric in streaming_metrics:
        if metric.name == HitRate.name:
            metric.add_sums(scalars["hit_matches"], scalars["clicks"])
        elif metric.name in _MEANS:
            total, count = _MEANS[metric.name]
            metric.add_sums(scalars[total], scalars[count])
        elif metric.name == HitRateBySessionPosition.name:
            if len(sums) == len(SCALARS):
                raise ValueError("the fold counted no positions: build it by_position")
            matches, clicks, pops = sums[len(SCALARS):].reshape(3, -1)
            metric.add_sums(matches, clicks, pops)


def add_coverage_counts(streaming_metrics: Sequence[StreamingMetric],
                        counts: Tuple[int, int]) -> None:
    """Hand ItemCoverage the hour's counts of recommended and clicked ids."""
    for metric in streaming_metrics:
        if metric.name == ItemCoverage.name:
            metric.add_sums(*counts)
