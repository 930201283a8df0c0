"""Operations and bytes the model's functions need, from their shapes.

Counts are of the work the inputs need, whatever implements it: each
matrix product once (2 operations a multiply-add), elementwise work left
out, each input byte read once and each output byte written once.  The
candidate scorer is counted as the pooled formulation computes it (the
PreCAR product's item half once per candidate article, its user half once
per row), the UGRNN over the valid (session, step) rows only.  A backward
is twice its forward's products."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def seconds(self, flops_per_s: float, bytes_per_s: float) -> float:
        """The least time a card with these peaks needs."""
        return max(self.flops / flops_per_s, self.bytes / bytes_per_s)


def _matching_macs(c: int, widths) -> int:
    macs, w = 0, c
    for m in list(widths) + [1]:
        macs += w * m
        w = m
    return macs


def _matching_params(c: int, widths) -> int:
    n, w = 0, c
    for m in list(widths) + [1]:
        n += w * m + m
        w = m
    return n


def scorer_forward(pairs: int, rows: int, c: int, widths, itemsize: int = 2) -> Work:
    """The fused scorer's function: for ``pairs`` (row, candidate) pairs of
    ``rows`` rows, tanh(leaky(item_pre + user_pre) W_car + b) * pred through
    the matching MLP to one score.  Reads the gathered item rows [pairs, C],
    the rows' user half and prediction [rows, C] and the weights; writes
    one float32 score a pair."""
    flops = 2.0 * pairs * (c * c + _matching_macs(c, widths))
    weights = c * c + c + _matching_params(c, widths)
    return Work(flops, itemsize * (pairs * c + 2 * rows * c + weights) + 4 * pairs)


def scorer_backward(pairs: int, rows: int, c: int, widths, itemsize: int = 2) -> Work:
    """Its gradient: twice the forward's products; reads what the forward
    read and the scores' gradient, writes the gradients of the item rows,
    the user half, the prediction and the weights."""
    fwd = scorer_forward(pairs, rows, c, widths, itemsize)
    weights = c * c + c + _matching_params(c, widths)
    read = fwd.bytes  # the forward's inputs, with the scores' gradient for the scores
    written = itemsize * (pairs * c + 2 * rows * c) + 4 * weights
    return Work(2 * fwd.flops, read + written)


def ugrnn_forward(valid_steps: int, grid_steps: int, units: int, itemsize: int = 2) -> Work:
    """One UGRNN layer's recurrence (the input projection is a separate
    product): h W_hh a valid step; reads the projected inputs of the valid
    steps and W_hh, writes h at every step of the grid."""
    flops = 2.0 * valid_steps * units * 2 * units
    return Work(flops, itemsize * (valid_steps * 2 * units + 2 * units * units
                                   + grid_steps * units))


def ugrnn_backward(valid_steps: int, grid_steps: int, units: int, itemsize: int = 2) -> Work:
    """Its gradient: da W_hh^T and h^T da a valid step; reads the outputs'
    gradient and the states, writes the projected inputs' gradient and
    dW_hh."""
    flops = 4.0 * valid_steps * units * 2 * units
    return Work(flops, itemsize * (grid_steps * units + valid_steps * units
                                   + 2 * units * units + valid_steps * 2 * units)
                + 4 * 2 * units * units)


@dataclass
class Shapes:
    """The model's widths, from a reference ``Model``."""

    user_dim: int
    item_dim: int
    c: int
    units: int
    layers: int
    widths: tuple

    @classmethod
    def of(cls, model) -> "Shapes":
        return cls(model.user_dim, model.item_dim, model.c, model.units, model.layers,
                   tuple(model.matching))


def encoder_flops(s: Shapes, rows: int) -> float:
    """The forward of ``rows`` valid (session, step) rows up to the
    prediction: the input and label CAR towers, the UGRNN layers with their
    input projections, FC1 and FC2."""
    f = s.user_dim + s.item_dim
    car = 2 * (f * s.c + s.c * s.c)
    rnn = 0
    for i in range(s.layers):
        width = s.c if i == 0 else s.units
        rnn += width * 2 * s.units + s.units * 2 * s.units
    fc = s.units * 512 + 512 * s.c
    return 2.0 * rows * (car + rnn + fc)


def scoring_flops(s: Shapes, rows: int, candidates: int, articles: int) -> float:
    """Scoring ``rows`` rows against ``candidates`` candidates each (and the
    label, whose CAR the encoder made), ``articles`` distinct candidate
    articles: the PreCAR halves once per row and per article, the CAR
    product and the matching MLP per pair."""
    pre = rows * s.user_dim * s.c + articles * s.item_dim * s.c
    pairs = rows * candidates
    return 2.0 * (pre + pairs * s.c * s.c + rows * (1 + candidates) * _matching_macs(s.c, s.widths))


def model_flops(s: Shapes, encoder_rows: int, scored_rows: int, candidates: int,
                articles: int, train: bool) -> float:
    fwd = encoder_flops(s, encoder_rows) + scoring_flops(s, scored_rows, candidates, articles)
    return 3.0 * fwd if train else fwd
