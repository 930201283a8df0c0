"""Plain reference of GRU4Rec, for deciding ``correct``.

Written from the published model (Hidasi et al., "Session-based
Recommendations with Recurrent Neural Networks", ICLR 2016,
arXiv:1511.06939; the bpr-max loss and the sampled shared negatives of
Hidasi & Karatzoglou, "Recurrent Neural Networks with Top-k Gains for
Session-based Recommendations", CIKM 2018, arXiv:1706.03847) as CHAMELEON's
reference bundles it (nar_module/nar/benchmarks/gru4rec/gru4rec2.py: the
cell at 392-431, the losses at 188-213, adagrad at 270-300) and the
configuration file, in plain PyTorch and float32 (TF32 off), importing
nothing of the system under test.

Per layer, with the input's 3U-wide projection ``v = x Wx + bh`` split as
``[v_h | v_r | v_z]`` and ``Wrz`` as ``[W_r | W_z]``:

  r = sigmoid(v_r + h W_r),  z = sigmoid(v_z + h W_z)
  c = tanh((r * h) Wh + v_h)                 the reset gate before Wh
  h' = (1 - z) h + z c

the first layer's ``x Wx`` a row of ``Wx`` by item id.  At step t, session i
scores the candidates ``[the batch's labels at t || n_sample negatives
shared by the batch]``: ``r_ij = h_i . Wy[j] + by[j]``, its own label on the
diagonal.  bpr-max-λ: with ``s`` the softmax of row i over its valid
candidates but its own label, ``-log sum_j sigmoid(r_ii - r_ij) s_j + λ
sum_j s_j r_ij^2``.  The loss is the mean over every (session, step) with a
label.  Adagrad: ``acc += g^2; p -= lr * g / sqrt(acc + eps)``, applied as
the reference does, to the rows of the item tables (``Wx`` of the first
layer, ``Wy``, ``by``) a step addresses and to every other parameter whole.

Departures from the published code, each from the framework GRU4Rec runs
in here:

  * sessions come as padded [B, T] batches of each session's first T + 1
    clicks (inputs all but the last, labels all but the first), not as
    session-parallel mini-batches; a step past a session's end keeps h, and
    its row and its label column count for nothing;
  * the negatives are drawn uniformly, with replacement, among the first
    ``neg_pool_capacity`` entries of the recent-clicks buffer (``Clicks``),
    not from the training set's popularity; the reference is handed the
    system's draws and checks them against that pool;
  * the weights are the benchmark's, drawn from the seed with the
    variance of the published uniform init (Glorot), biases zero.

``precision`` "bf16" or "fp8" rounds every matrix product's operands (the
first layer's rows of ``Wx`` included) to bfloat16, or to float8 (e4m3, one
scale per tensor), on the way in, with the gradient passed straight
through: the controls that the comparison has to fail.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

EPS_LOG = 1e-24


class Model:
    """The configuration's shapes and hyperparameters (its ``gru4rec``
    block)."""

    def __init__(self, config: dict):
        g = config["gru4rec"]
        self.config = config
        self.n_items = int(g["n_items"])
        self.layers = [int(u) for u in g["layers"]]
        self.loss = str(g["loss"])
        self.bpreg = float(g["bpreg"])
        self.n_sample = int(g["n_sample"])
        self.lr = float(g["learning_rate"])
        self.eps = float(g["adagrad_eps"])
        self.batch_size = int(g["batch_size"])
        self.t = int(g["truncate_session_length"]) - 1
        self.pool = int(g["neg_pool_capacity"])
        self.buffer_max = int(g["recent_clicks_buffer_max_size"])
        self.buffer_s = int(float(g["recent_clicks_buffer_hours"]) * 3600)

    def param_shapes(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """(name, shape, kind) of every parameter, under the system's names."""
        out, width = [], self.n_items
        for i, u in enumerate(self.layers):
            out += [(f"wx.{i}", (width, 3 * u), "glorot"), (f"wh.{i}", (u, u), "glorot"),
                    (f"wrz.{i}", (u, 2 * u), "glorot"), (f"bh.{i}", (3 * u,), "zeros")]
            width = u
        return out + [("wy", (self.n_items, self.layers[-1]), "glorot"),
                      ("by", (self.n_items,), "zeros")]

    TABLES = ("wx.0", "wy", "by")  # the parameters indexed by item id


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        if kind == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        amax = x.detach().abs().max().clamp_min(1e-30)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def q(self, x):
        return x if self.name == "f32" else _Round.apply(x, self.name)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


# ---------------------------------------------------------------------------
# collation and the recent-clicks buffer
# ---------------------------------------------------------------------------

def train_batch(model: Model, sessions: Sequence[dict]) -> Dict[str, np.ndarray]:
    """A session's first ``T + 1`` clicks: the inputs all but the last, the
    labels all but the first, the last click and the input clicks' times
    apart; ``batch_size`` rows, empty past the sessions."""
    t, b = model.t, model.batch_size
    out = {"items": np.zeros((b, t), np.int64), "labels": np.zeros((b, t), np.int64),
           "last": np.zeros((b, 1), np.int64), "ts": np.zeros((b, t), np.int64)}
    for i, s in enumerate(sessions):
        items = list(s["items"])[:t + 1]
        n = len(items)
        out["items"][i, :n - 1] = items[:-1]
        out["labels"][i, :n - 1] = items[1:]
        out["last"][i, 0] = items[-1]
        out["ts"][i, :n - 1] = list(s["ts"])[:n - 1]
    return out


class Clicks:
    """The recent-clicks buffer the negatives are drawn from: each batch's
    clicks (its inputs, then each session's last click stamped with the
    session's latest input time) newest first, taken as the batch's
    row-major order reversed, ahead of the clicks kept from before that are
    at most ``buffer_s`` older than the batch's oldest; the first
    ``buffer_max`` kept."""

    def __init__(self, model: Model):
        self.model = model
        self.ids: List[int] = []
        self.ts: List[int] = []

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        ids = np.concatenate([batch["items"], batch["last"]], 1).reshape(-1)
        ts = np.concatenate([batch["ts"], batch["ts"].max(1, keepdims=True)], 1).reshape(-1)
        keep = ids != 0
        new_ids, new_ts = ids[keep][::-1].tolist(), ts[keep][::-1].tolist()
        oldest = min(new_ts) if new_ts else 0
        kept = [(i, s) for i, s in zip(self.ids, self.ts) if s >= oldest - self.model.buffer_s]
        merged = (list(zip(new_ids, new_ts)) + kept)[: self.model.buffer_max]
        self.ids = [i for i, _ in merged]
        self.ts = [s for _, s in merged]

    def pool(self) -> List[int]:
        """The ids a step's negatives may be: the first ``pool`` nonzero."""
        return [i for i in self.ids if i != 0][: self.model.pool]


def negative_faults(negs: torch.Tensor, pool: Sequence[int], n_sample: int) -> int:
    """Negatives outside the pool, and each one short of or past
    ``n_sample``."""
    allowed = torch.as_tensor(sorted(set(pool)), device=negs.device)
    return int((~torch.isin(negs.long(), allowed)).sum()) + abs(negs.numel() - n_sample)


def touched(items, labels, negs, n_items: int) -> torch.Tensor:
    """[n_items] bool: the rows a step addresses, by its inputs, its labels
    and its negatives."""
    mask = torch.zeros(n_items, dtype=torch.bool, device=negs.device)
    for ids in (items, labels, negs):
        mask[ids.reshape(-1).long()] = True
    return mask


# ---------------------------------------------------------------------------
# the model, the losses, Adagrad
# ---------------------------------------------------------------------------

def states(model: Model, params, items, labels, prec: Precision):
    """Hidden states [B, T, U] of the last layer; a step past the session's
    end (no label) keeps h."""
    b, t = items.shape
    live = labels != 0
    x = None
    for i, u in enumerate(model.layers):
        h = params["wx.0"].new_zeros((b, u))
        if i == 0:
            proj = prec.q(params["wx.0"][items])
        outs = []
        for step in range(t):
            if i == 0:
                v = proj[:, step] + params["bh.0"]
            else:
                v = prec.mm(x[:, step], params[f"wx.{i}"]) + params[f"bh.{i}"]
            v_h, v_r, v_z = v[:, :u], v[:, u:2 * u], v[:, 2 * u:]
            w_r, w_z = params[f"wrz.{i}"][:, :u], params[f"wrz.{i}"][:, u:]
            r = torch.sigmoid(v_r + prec.mm(h, w_r))
            z = torch.sigmoid(v_z + prec.mm(h, w_z))
            c = torch.tanh(prec.mm(r * h, params[f"wh.{i}"]) + v_h)
            new = (1 - z) * h + z * c
            h = torch.where(live[:, step:step + 1], new, h)
            outs.append(h)
        x = torch.stack(outs, 1)
    return x


def scores(model: Model, params, hs, labels, negs, prec: Precision):
    """[T, B, B + n] scores of each step's rows against its candidates."""
    t = hs.shape[1]
    cand = torch.cat([labels.T, negs[None, :].expand(t, -1)], 1)  # [T, B + n]
    wy, by = params["wy"][cand], params["by"][cand]
    return torch.stack([prec.mm(hs[:, step], wy[step].T) + by[step] for step in range(t)])


def _own(b: int, c: int, device):
    return torch.eye(b, c, dtype=torch.bool, device=device)


def row_losses(loss: str, r, valid_col, bpreg: float):
    """Per-row loss of a step's scores ``r`` [B, C] (column i of row i its
    label; ``valid_col`` [C] the columns that count)."""
    b, c = r.shape
    own = _own(b, c, r.device)
    pos = r.diagonal()[:, None]
    cols = valid_col[None, :].expand(b, c)
    if loss in ("bpr-max", "top1-max"):
        others = cols & ~own
        s = torch.softmax(r.masked_fill(~others, -math.inf), 1)
        if loss == "bpr-max":
            return (-torch.log((torch.sigmoid(pos - r) * s).sum(1) + EPS_LOG)
                    + bpreg * (s * r * r).sum(1))
        return (s * (torch.sigmoid(r - pos) + torch.sigmoid(r * r))).sum(1)
    if loss == "cross-entropy":
        logp = torch.log_softmax(r.masked_fill(~(cols | own), -math.inf), 1)
        return -logp.diagonal()
    n_cols = cols.float().sum(1)
    if loss == "bpr":
        return (-torch.nn.functional.logsigmoid(pos - r) * cols).sum(1) / n_cols
    if loss == "top1":
        term = torch.sigmoid(r - pos) + torch.sigmoid(r * r)
        return ((term * cols).sum(1) - torch.sigmoid(pos[:, 0] ** 2)) / n_cols
    raise ValueError(f"unknown loss {loss}")


def loss_and_scores(model: Model, params, items, labels, negs, prec: Precision):
    """(the mean loss over every (session, step) with a label, [T, B, B + n]
    scores)."""
    hs = states(model, params, items, labels, prec)
    sc = scores(model, params, hs, labels, negs, prec)
    total, rows = sc.new_zeros(()), 0
    for step in range(sc.shape[0]):
        live = labels[:, step] != 0
        valid_col = torch.cat([live, torch.ones_like(negs, dtype=torch.bool)])
        per_row = row_losses(model.loss, sc[step], valid_col, model.bpreg)
        total = total + per_row[live].sum()
        rows += int(live.sum())
    return total / max(rows, 1), sc


class Adagrad:
    """``acc += g^2; p -= lr * g / sqrt(acc + eps)``: the item tables on the
    rows a step addresses, the other parameters whole."""

    def __init__(self, model: Model, params):
        self.model = model
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads, rows: torch.Tensor):
        m = self.model
        for n, p in params.items():
            g, acc = grads[n], self.acc[n]
            if n in Model.TABLES:
                g, a = g[rows], acc[rows] + g[rows] * g[rows]
                acc[rows] = a
                p[rows] = p[rows] - m.lr * g / torch.sqrt(a + m.eps)
            else:
                acc += g * g
                p -= m.lr * g / torch.sqrt(acc + m.eps)


def train_steps(model: Model, params0: Dict[str, torch.Tensor], batches: Sequence[dict],
                negs: Sequence[torch.Tensor], prec: Precision):
    """Run the steps the system ran, each ``(items, labels)`` with its
    negatives.  Returns (the losses, the first step's scores, its gradient
    by leaf, the parameters after the last step)."""
    params = {n: p.detach().clone().requires_grad_(True) for n, p in params0.items()}
    opt = Adagrad(model, params)
    losses, first_scores, first_grad = [], None, None
    for batch, neg in zip(batches, negs):
        loss, sc = loss_and_scores(model, params, batch["items"], batch["labels"], neg, prec)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if first_grad is None:
            first_scores = sc.detach()
            first_grad = {n: g.detach().clone() for n, g in grads.items()}
        rows = torch.nonzero(touched(batch["items"], batch["labels"], neg,
                                     model.n_items))[:, 0]
        opt.step(params, grads, rows)
        losses.append(float(loss.detach()))
    return losses, first_scores, first_grad, {n: p.detach() for n, p in params.items()}
