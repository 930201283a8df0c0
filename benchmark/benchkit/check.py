"""The numbers that decide ``correct``, each a widest gap between what the
system produced and what the plain reference works out, and the helpers
that read them.  A gap in probability is taken in logits (natural log of
the probability, floored at 1e-30); a gap in a norm is measured against the
reference's norm of that leaf or of the median leaf, whichever is larger."""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch

FLOOR = 1e-30


def log_p(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p.double().clamp_min(FLOOR))


def top_slots(p: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` slots of the largest probabilities per row, stable."""
    return torch.sort(p, dim=-1, descending=True, stable=True).indices[..., :n]


def prob_gap(p_sys: torch.Tensor, p_ref: torch.Tensor, rows: torch.Tensor, n: int) -> float:
    """Widest |log p_sys - log p_ref| over the system's top ``n`` slots of
    the ``rows`` (a bool mask over the leading axis) that count."""
    if not bool(rows.any()):
        return 0.0
    a, b = p_sys[rows], p_ref[rows]
    slots = top_slots(a, n)
    return float((log_p(a.gather(-1, slots)) - log_p(b.gather(-1, slots))).abs().max())


def rank_gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """Widest distance, in logits, by which the j-th choice of the system
    (``chosen`` [R, N] slots) lies below the reference's j-th best."""
    best = torch.sort(ref_logits, -1, descending=True).values[:, : chosen.shape[-1]]
    return float((best - ref_logits.gather(-1, chosen)).max().clamp_min(0.0))


def norm_gap(sys_norms: Dict[str, float], ref_norms: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    """Worst leaf's |norm_sys - norm_ref| over max(norm_ref of the leaf,
    median leaf's norm_ref)."""
    leaves = list(ref_norms if leaves is None else leaves)
    if not leaves:
        return 0.0
    med = sorted(ref_norms[n] for n in leaves)[len(leaves) // 2]
    worst = 0.0
    for n in leaves:
        denom = max(ref_norms[n], med, 1e-30)
        worst = max(worst, abs(sys_norms.get(n, math.inf) - ref_norms[n]) / denom)
    return worst


def moving_leaves(grad_norms: Dict[str, float], share: float = 1e-3):
    """Leaves whose reference gradient is no round-off: at least ``share``
    of the median leaf's."""
    vals = sorted(grad_norms.values())
    med = vals[len(vals) // 2]
    return [n for n, v in grad_norms.items() if v >= share * med]


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.detach().double().norm()) for n, t in tensors.items()}
