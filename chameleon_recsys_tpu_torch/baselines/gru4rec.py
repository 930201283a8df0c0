"""GRU4Rec, the port of ``chameleon_recsys_tpu/baselines/gru4rec.py`` (the
reference bundles Hidasi's Theano implementation,
nar_module/nar/benchmarks/gru4rec/gru4rec2.py).

Semantics are the JAX package's:
  * GRU4Rec's cell, ``h' = (1 - z) h + z tanh((r * h) Wh + Wx x)``: the reset
    gate multiplies h before ``Wh`` (cuDNN's, and so ``torch.nn.GRU``'s,
    applies it after the product), so the recurrence is written out over the
    T steps; padded steps carry h through;
  * the first layer gathers rows of its input matrix by item id;
  * scores ``h . Wy[Y]^T + By[Y]`` over ``[step positives || n_sample shared
    negatives]``, a row's own positive on the diagonal; the five losses
    (``LOSSES``), batched over the steps, give the same per-step values;
  * inter-layer dropout through ``ops/dropout.py`` (``_draw_mask`` is the one
    hook for injected masks);
  * the optimizer is the reference's update rule by hand (``ReferenceOptimizer``:
    its adagrad, rmsprop, adadelta and one-decay adam, or sgd; then decayed
    weights, momentum and the scale by -lr), dense over every parameter as
    in JAX: ``torch.optim``'s Adagrad and RMSprop divide by ``sqrt(acc) +
    eps`` where the reference divides by ``sqrt(acc + eps)``, and its Adam
    has two decays where the reference shares one.

Negatives are drawn uniformly, with replacement, among the first
``neg_pool_capacity`` nonzero entries of the recent-clicks buffer
(``_draw_negative_indices``, the hook tests replace to inject JAX's draws);
JAX's padding of that pool to a fixed length kept its step from recompiling
and has no counterpart.  ``fit_batch`` returns the loss as a device scalar,
so that a training loop fetches an hour's losses once.

On a CUDA device a step's forward, loss and backward, ~1,100 launches at
the G1 widths, replay as one CUDA graph per batch shape (``StepGraphs``,
under ``graphs.py``'s rule: a shape's first call eager, its second
captured), where a replay does what the eager step does: no dropout masks
drawn inside it and no Python run there (hooks, a replaced
``loss_for_batch`` or loss).  The graph reads its own copies of the items,
labels and negatives, and makes the gradients in its pool; the draw of the
negatives and the update stay eager, so the update is what it was.

A step's spans (``utils/profiling.py``, off unless tracing is on):
``gru4rec.sample`` (the pool and the draw), ``gru4rec.forward`` (the model
and the loss) and ``gru4rec.backward`` where they run eagerly,
``gru4rec.step.capture`` and ``gru4rec.step.replay`` where they run as a
graph, and ``gru4rec.update``.  While tracing is on, on the card, a step
also counts on the device the rows of the item tables it touches
(``rows_touched``); ``flush_counts`` adds the sums to the counter
``gru4rec.rows_touched`` with one fetch, which the runner makes once an
hour.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graphs import Graph, GraphCache, hooked
from ..ops.dropout import dropout
from ..utils.profiling import add_counts, span, tracing


def to_device(array, device: torch.device, dtype=torch.long) -> torch.Tensor:
    """A host array on ``device`` without a host sync: a card's copy goes
    through pinned memory, queued on the current stream."""
    tensor = torch.as_tensor(np.ascontiguousarray(array), dtype=dtype)
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


class GRU4RecParams(nn.Module):
    """The JAX ``GRU4RecParams``: per layer ``wx`` ([n_items, 3U] for the
    first, [U_prev, 3U] after), ``wh`` [U, U], ``wrz`` [U, 2U], ``bh`` [3U];
    then ``wy`` [n_items, U_last] and ``by`` [n_items]."""

    def __init__(self, n_items: int, layers: Sequence[int]):
        super().__init__()
        self.wx, self.wh = nn.ParameterList(), nn.ParameterList()
        self.wrz, self.bh = nn.ParameterList(), nn.ParameterList()
        in_dim = n_items
        for units in layers:
            self.wx.append(nn.Parameter(torch.empty(in_dim, 3 * units)))
            self.wh.append(nn.Parameter(torch.empty(units, units)))
            self.wrz.append(nn.Parameter(torch.empty(units, 2 * units)))
            self.bh.append(nn.Parameter(torch.zeros(3 * units)))
            in_dim = units
        self.wy = nn.Parameter(torch.empty(n_items, layers[-1]))
        self.by = nn.Parameter(torch.zeros(n_items))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The reference's init (``init_gru4rec_params``): each matrix
        U(+-sqrt(6 / (fan_in + fan_out))), the biases zero."""
        for w in (*self.wx, *self.wh, *self.wrz, self.wy):
            bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            w.uniform_(-bound, bound, generator=generator)
        for b in (*self.bh, self.by):
            b.zero_()


def forward_states(params: GRU4RecParams, items: torch.Tensor, mask: torch.Tensor,
                   dropout_p_hidden: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Hidden states of every step, items [B, T] -> [B, T, U_last]; with
    ``dropout_p_hidden`` > 0 each layer's output is dropped out (training)."""
    b, t = items.shape
    h_seq = None
    for i, wh in enumerate(params.wh):
        units = wh.shape[0]
        if i == 0:
            vec = params.wx[0][items] + params.bh[0]  # [B, T, 3U] row gather
        else:
            vec = h_seq @ params.wx[i] + params.bh[i]
        h = vec.new_zeros((b, units))
        outs = []
        for step in range(t):
            vec_t = vec[:, step]
            rz = torch.sigmoid(vec_t[:, units:] + h @ params.wrz[i])
            r, z = rz[:, :units], rz[:, units:]
            cand = torch.tanh((h * r) @ wh + vec_t[:, :units])
            h_new = (1.0 - z) * h + z * cand
            h = torch.where(mask[:, step, None], h_new, h)
            outs.append(h)
        h_seq = torch.stack(outs, dim=1)
        if dropout_p_hidden > 0.0:
            h_seq = dropout(h_seq, 1.0 - dropout_p_hidden, generator)
    return h_seq


# ---------------------------------------------------------------------------
# Losses over scores [..., N, C]: column j < N is row j's positive (row i's
# own on the diagonal), the rest are the shared negatives; valid_row [..., N]
# and valid_col [..., C] mask padding.  Each returns the mean over valid rows,
# one value per leading index.
# ---------------------------------------------------------------------------

def _diagonal(scores):
    n = scores.shape[-2]
    return torch.diagonal(scores[..., :n], dim1=-2, dim2=-1)


def _eye(scores):
    return torch.eye(*scores.shape[-2:], dtype=torch.bool, device=scores.device)


def _row_mean(per_row, valid_row):
    w = valid_row.float()
    return (per_row * w).sum(-1) / w.sum(-1).clamp(min=1.0)


def _softmax_neg(scores, valid_col):
    """Row softmax over the valid columns but the row's own positive."""
    eye = _eye(scores)
    col_invalid = ~valid_col[..., None, :] & ~eye
    return torch.softmax(scores.masked_fill(eye | col_invalid, -math.inf), dim=-1)


def bpr_max_loss(scores, valid_row, valid_col, bpreg):
    """-log sum_j sigma(r_ii - r_ij) s_ij + bpreg sum_j r_ij^2 s_ij
    (gru4rec2.py:203-205)."""
    s = _softmax_neg(scores, valid_col)
    sig = torch.sigmoid(_diagonal(scores)[..., None] - scores)
    per_row = -torch.log((sig * s).sum(-1) + 1e-24) + bpreg * (scores.square() * s).sum(-1)
    return _row_mean(per_row, valid_row)


def cross_entropy_loss(scores, valid_row, valid_col, _bpreg=0.0):
    masked = torch.where(_eye(scores), scores,
                         scores.masked_fill(~valid_col[..., None, :], -math.inf))
    return _row_mean(-_diagonal(F.log_softmax(masked, dim=-1)), valid_row)


def bpr_loss(scores, valid_row, valid_col, _bpreg=0.0):
    """Mean of -log sigma(r_ii - r_ij) over the valid columns, the diagonal
    included as in the reference (gru4rec2.py ``bpr``)."""
    ls = -F.logsigmoid(_diagonal(scores)[..., None] - scores)
    colw = valid_col[..., None, :].float()
    per_row = (ls * colw).sum(-1) / colw.sum(-1).clamp(min=1.0)
    return _row_mean(per_row, valid_row)


def top1_loss(scores, valid_row, valid_col, _bpreg=0.0):
    """Mean of sigma(r_ij - r_ii) + sigma(r_ij^2) over the valid columns,
    less the diagonal's sigma(r_ii^2) share (gru4rec2.py ``top1``)."""
    diag = _diagonal(scores)
    term = torch.sigmoid(scores - diag[..., None]) + torch.sigmoid(scores.square())
    colw = valid_col[..., None, :].float()
    n_out = colw.sum(-1).clamp(min=1.0)
    per_row = (term * colw).sum(-1) / n_out - torch.sigmoid(diag.square()) / n_out
    return _row_mean(per_row, valid_row)


def top1_max_loss(scores, valid_row, valid_col, _bpreg=0.0):
    """TOP1 terms weighted by the softmax over the negatives
    (gru4rec2.py ``top1_max``)."""
    s = _softmax_neg(scores, valid_col)
    term = (torch.sigmoid(scores - _diagonal(scores)[..., None])
            + torch.sigmoid(scores.square()))
    return _row_mean((s * term).sum(-1), valid_row)


LOSSES = {
    "bpr-max": bpr_max_loss,
    "cross-entropy": cross_entropy_loss,
    "bpr": bpr_loss,
    "top1": top1_loss,
    "top1-max": top1_max_loss,
}
_OWN_LOSSES = dict(LOSSES)


def parse_loss(loss: str, bpreg: float = 0.5) -> Tuple[str, float]:
    """The reference's loss strings (gru4rec2.py:138-147): 'cross-entropy' |
    'bpr' | 'bpr-max-<X>' | 'top1' | 'top1-max', and plain 'bpr-max' with
    ``bpreg`` from the argument."""
    if loss.startswith("bpr-max-"):
        return "bpr-max", float(loss[len("bpr-max-"):])
    if loss not in LOSSES:
        raise ValueError(f"unknown GRU4Rec loss {loss!r}; valid: {sorted(LOSSES)}")
    return loss, bpreg


# ---------------------------------------------------------------------------
# The optimizer: the reference's learning-rate adaptations
# (gru4rec2.py:270-344) and its update rule (gru4rec2.py:345-391).
# ---------------------------------------------------------------------------

ADAPTATIONS = ("adagrad", "rmsprop", "adadelta", "adam", "sgd")


def _adapt(adapt: str, g, state, decay: float, eps: float):
    """The adapted gradient of ``g``; updates the parameter's ``state``."""
    if adapt == "sgd":
        return g
    if adapt == "adagrad":  # acc += g^2; g / sqrt(acc + eps)
        acc = state.setdefault("acc", torch.zeros_like(g))
        acc.addcmul_(g, g)
        return g / (acc + eps).sqrt_()
    if adapt == "rmsprop":  # acc = d acc + (1 - d) g^2; g / sqrt(acc + eps)
        acc = state.setdefault("acc", torch.zeros_like(g))
        acc.mul_(decay).add_((1.0 - decay) * g * g)
        return g / (acc + eps).sqrt_()
    if adapt == "adadelta":
        # the reference's variant: acc += g^2; g <- sqrt(upd + eps) g;
        # upd = d upd + (1 - d) g^2; g / sqrt(acc + eps)
        acc = state.setdefault("acc", torch.zeros_like(g))
        upd = state.setdefault("upd", torch.zeros_like(g))
        acc.addcmul_(g, g)
        scaled = (upd + eps).sqrt_() * g
        upd.mul_(decay).add_((1.0 - decay) * scaled * scaled)
        return scaled / (acc + eps).sqrt_()
    # adam, the reference's variant with ONE decay for both moments:
    # m-hat / (sqrt(acc-hat) + eps), corrected by 1 - d^t
    acc = state.setdefault("acc", torch.zeros_like(g))
    meang = state.setdefault("meang", torch.zeros_like(g))
    state["count"] = state.get("count", 0) + 1
    acc.mul_(decay).add_((1.0 - decay) * g * g)
    meang.mul_(decay).add_((1.0 - decay) * g)
    corr = 1.0 - decay ** state["count"]
    return (meang / corr) / ((acc / corr).sqrt_() + eps)


class ReferenceOptimizer(torch.optim.Optimizer):
    """The JAX ``make_reference_optimizer`` chain by hand: the adapted
    gradient, then ``+ lmbd * p`` where ``lmbd`` > 0, then the momentum trace
    ``v = out + momentum * v`` where ``momentum`` > 0, then ``p += -lr * out``;
    dense over every parameter with a gradient."""

    def __init__(self, params, adapt: str = "adagrad", learning_rate: float = 0.05,
                 decay: float = 0.9, momentum: float = 0.0, lmbd: float = 0.0,
                 eps: float = 1e-6):
        adapt = adapt or "sgd"
        if adapt not in ADAPTATIONS:
            raise ValueError(f"unknown GRU4Rec optimizer {adapt!r}; valid: "
                             + ", ".join(ADAPTATIONS))
        super().__init__(params, dict(lr=learning_rate, adapt=adapt, decay=decay,
                                      momentum=momentum, lmbd=lmbd, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                out = _adapt(group["adapt"], p.grad, state, group["decay"], group["eps"])
                if group["lmbd"] > 0.0:
                    out = out + group["lmbd"] * p
                if group["momentum"] > 0.0:
                    trace = state.setdefault("trace", torch.zeros_like(p))
                    out = trace.mul_(group["momentum"]).add_(out)
                p.add_(out * -group["lr"])


def rows_touched(params: GRU4RecParams) -> torch.Tensor:
    """[rows of ``wx[0]``, rows of ``wy`` / ``by``] with a nonzero gradient,
    an int64 pair on the parameters' device, counted without a host sync."""
    wx, wy, by = params.wx[0].grad, params.wy.grad, params.by.grad
    return torch.stack([wx.ne(0).any(1).sum(),
                        (wy.ne(0).any(1) | by.ne(0)).sum()])


class StepGraph(Graph):
    """GRU4Rec's forward, loss and backward of one batch shape: from its
    capture, its copies of the items, labels and negatives, and the
    gradients its backward makes.  A call is (items, labels, negatives) on
    the card."""

    def __init__(self, model: "GRU4Rec"):
        self.model = model

    def eager(self, *call):
        return self.model._forward_backward(*call)

    def buffers(self, *call) -> None:
        self.inputs = [t.clone() for t in call]

    def work(self):
        loss = self.model._forward_backward(*self.inputs)
        self.grads = [p.grad for p in self.model.params.parameters()]
        return loss

    def load(self, *call) -> None:
        for mine, given in zip(self.inputs, call):
            mine.copy_(given)

    def returns(self, loss, *call):
        """A copy of the replay's loss; the parameters' ``.grad`` the
        graph's gradients."""
        for p, grad in zip(self.model.params.parameters(), self.grads):
            if p.grad is not grad:
                p.grad = grad
        return loss.clone()


class StepGraphs(GraphCache):
    """The step graphs of one GRU4Rec, by the shapes of the batch and the
    negatives; dropped when a parameter is another tensor."""

    def __init__(self):
        super().__init__("gru4rec.step")
        self.reads = None

    def step(self, model: "GRU4Rec", items, labels, neg_sample) -> torch.Tensor:
        reads = tuple(p.data_ptr() for p in model.params.parameters())
        if reads != self.reads:
            self.clear()
            self.reads = reads
        key = (tuple(items.shape), tuple(labels.shape), tuple(neg_sample.shape))
        graph = self.graph(key, lambda: StepGraph(model))
        return self.run(key, graph, items, labels, neg_sample)


def _draw_negative_indices(n_sample: int, n_valid: int,
                           generator: torch.Generator) -> torch.Tensor:
    """``n_sample`` uniform indices in [0, n_valid) on the generator's device."""
    return torch.randint(0, n_valid, (n_sample,), generator=generator,
                         device=generator.device)


class GRU4Rec:
    """The trainer (the JAX ``GRU4RecJax``) over padded [B, T] session
    batches, on ``device``."""

    recommender_name = "gru4rec"  # the CSV column suffix

    def __init__(
        self,
        n_items: int,
        layers: Tuple[int, ...] = (300,),
        loss: str = "bpr-max",
        bpreg: float = 0.5,
        learning_rate: float = 0.05,
        n_sample: int = 200,
        dropout_p_hidden: float = 0.0,
        optimizer: str = "adagrad",
        decay: float = 0.9,
        momentum: float = 0.0,
        lmbd: float = 0.0,
        seed: int = 42,
        neg_pool_capacity: int = 20000,
        device="cuda",
    ):
        self.n_items = n_items
        self.layers = tuple(layers)
        self.loss_name, self.bpreg = parse_loss(loss, bpreg)
        self.n_sample = n_sample
        self.neg_pool_capacity = int(neg_pool_capacity)
        self.dropout_p_hidden = dropout_p_hidden
        self.device = torch.device(device)
        params = GRU4RecParams(n_items, self.layers)
        params.reset_parameters(torch.Generator().manual_seed(seed))
        self.params = params.to(self.device)
        self.optimizer = ReferenceOptimizer(
            self.params.parameters(), optimizer, learning_rate, decay=decay,
            momentum=momentum, lmbd=lmbd)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._counts: Optional[torch.Tensor] = None  # [steps, wx rows, wy rows]
        self.graphs = StepGraphs() if self.device.type == "cuda" else None

    def replayable(self) -> bool:
        """Whether a replay of the forward and backward does what the eager
        ones do: no dropout masks drawn in them, no Python run in them."""
        return (self.dropout_p_hidden == 0.0 and "loss_for_batch" not in vars(self)
                and LOSSES[self.loss_name] is _OWN_LOSSES[self.loss_name]
                and not hooked(self.params))

    def loss_for_batch(self, items, labels, mask, neg_sample):
        """The training loss of a batch: each step's loss over ``[labels_t ||
        neg_sample]``, weighted by the step's valid rows (one batched product
        over T)."""
        h = forward_states(self.params, items, mask, self.dropout_p_hidden, self.generator)
        t = h.shape[1]
        cand = torch.cat([labels.T, neg_sample.expand(t, -1)], dim=1)  # [T, B + n]
        scores = (h.transpose(0, 1) @ self.params.wy[cand].transpose(1, 2)
                  + self.params.by[cand][:, None, :])  # [T, B, B + n]
        mask_t = mask.T
        valid_col = torch.cat([mask_t, mask_t.new_ones((t, neg_sample.shape[0]))], dim=1)
        losses = LOSSES[self.loss_name](scores, mask_t, valid_col, self.bpreg)
        counts = mask_t.float().sum(1)
        return (losses * counts).sum() / counts.sum().clamp(min=1.0)

    def fit_batch(self, items: np.ndarray, labels: np.ndarray,
                  buffer_ids: np.ndarray) -> torch.Tensor:
        """One training step on a padded [B, T] batch (items = clicks[:-1],
        labels = clicks[1:]); the loss as a device scalar."""
        with span("gru4rec.sample"):
            nonzero = buffer_ids[buffer_ids != 0]
            if len(nonzero) == 0:
                nonzero = np.array([1])
            nonzero = nonzero[: self.neg_pool_capacity]
            pool = to_device(nonzero, self.device)
            neg_sample = pool[_draw_negative_indices(self.n_sample, len(nonzero),
                                                     self.generator)]
        items_t, labels_t = to_device(items, self.device), to_device(labels, self.device)
        if self.graphs is not None and self.replayable():
            loss = self.graphs.step(self, items_t, labels_t, neg_sample)
        else:
            loss = self._forward_backward(items_t, labels_t, neg_sample)
        if self.device.type == "cuda" and tracing():
            self._count_rows()
        with span("gru4rec.update"):
            self.optimizer.step()
        return loss

    def _forward_backward(self, items, labels, neg_sample) -> torch.Tensor:
        """The loss of a batch on the device, and its gradients in the
        parameters' ``.grad``."""
        with span("gru4rec.forward"):
            loss = self.loss_for_batch(items, labels, labels != 0, neg_sample)
        with span("gru4rec.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        return loss.detach()

    def _count_rows(self):
        """Add this step's touched rows to the device-side sums."""
        step = torch.cat([torch.ones(1, dtype=torch.int64, device=self.device),
                          rows_touched(self.params)])
        self._counts = step if self._counts is None else self._counts + step

    def flush_counts(self) -> None:
        """Add the steps' touched rows counted since the last flush to the
        counter ``gru4rec.rows_touched`` (fields ``steps``, ``wx``, ``wy``):
        one fetch, nothing where no step counted."""
        if self._counts is None:
            return
        steps, wx, wy = self._counts.tolist()
        self._counts = None
        add_counts("gru4rec.rows_touched", steps=steps, wx=wx, wy=wy)

    @torch.no_grad()
    def score_candidates(self, items, mask, candidate_ids):
        """candidate_ids [B, T, C] -> scores [B, T, C]."""
        h = forward_states(self.params, items, mask)
        return (torch.einsum("btu,btcu->btc", h, self.params.wy[candidate_ids])
                + self.params.by[candidate_ids])

    def rank_candidates(self, items: np.ndarray, labels: np.ndarray,
                        neg_items: np.ndarray) -> np.ndarray:
        """Ranked candidate ids [B, T, 1 + K] of ``[label || neg_items]``, the
        framework's eval contract: padding (id 0) last, ties in order."""
        candidates = np.concatenate([labels[..., None], neg_items], axis=2)
        scores = self.score_candidates(
            to_device(items, self.device), to_device(labels != 0, self.device, torch.bool),
            to_device(candidates, self.device)).cpu().numpy()
        scores = np.where(candidates == 0, -np.inf, scores)
        order = np.argsort(-scores, axis=2, kind="stable")
        return np.take_along_axis(candidates, order, axis=2)
