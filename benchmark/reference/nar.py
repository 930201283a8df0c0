"""Plain reference of the CHAMELEON NAR model, for deciding ``correct``.

Written from the model's published description and the configuration file,
in plain PyTorch and float32 (TF32 off), with no kernel, cache, pooling or
batching trick, and importing nothing of the system under test.  It takes
only what the benchmark made from the seed (weights by parameter name,
articles, ACEs, sessions, the click history) and the system's outputs, which
it judges.  What the system derives from those inputs (the click buffer and
its popularity, the candidates, the compacted rows) is worked out again here.

One forward pass, per (session, step) row:

  user context (one-hot for <= 10 classes, else an embedding of
  floor(8 * classes ** 0.25)) | item features (metadata towers, the ACE,
  the item embedding, recency and novelty normalised against the click
  buffer) -> x * gamma + beta -> leaky(x W_pre + b_pre) -> tanh(. W_car +
  b_car)  [inputs, labels, candidates]
  -> UGRNN layers over the session (g = sigmoid(a_g + 1), c = tanh(a_c),
  h' = g h + (1 - g) c, steps past the end keep h) -> zeroed past the end
  -> leaky(FC1) -> tanh(FC2) = predicted
  -> matching MLP on (predicted * candidate) -> softmax(score / temperature)
  over [label | candidates].

``precision="fp8"`` rounds every matrix product's operands to float8 (e4m3,
one scale per tensor) on the way in, with the gradient passed straight
through: the control that the comparison has to fail.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LEAKY = 0.2  # tf.nn.leaky_relu's slope, which the published model uses
FORGET_BIAS = 1.0
SECONDS_PER_DAY = 86400
EPS = 1e-24
STRUCTURAL_SEQUENCE = ("event_timestamp", "item_clicked")
STRUCTURAL_ARTICLE = ("article_id", "created_at_ts")


def emb_dim(cardinality: int, mult: int = 8) -> int:
    return int(math.floor(mult * cardinality ** 0.25))


@dataclass(frozen=True)
class Feature:
    name: str
    kind: str  # categorical | numerical
    card: int  # classes of a categorical feature, else 0


def _features(rows) -> Tuple[Feature, ...]:
    return tuple(Feature(r[0], r[1], r[2] if r[1] == "categorical" else 0) for r in rows)


class Model:
    """The configuration's shapes: features, widths and hyperparameters."""

    def __init__(self, config: dict):
        self.config = config
        nar = config["nar"]
        self.nar = nar
        self.num_items = int(config["num_items"])
        self.ace_dim = int(config["ace_dim"])
        self.ctx = tuple(f for f in _features(config["session_sequence"])
                         if f.name not in STRUCTURAL_SEQUENCE)
        self.meta = tuple(f for f in _features(config["article_features"])
                          if f.name not in STRUCTURAL_ARTICLE)
        self.ohe_max = int(nar["max_cardinality_for_ohe"])
        self.c = int(nar["car_embedding_size"])
        self.units = int(nar["rnn_units"])
        self.layers = int(nar["rnn_num_layers"])
        self.matching = [int(m) for m in nar["matching_layer_sizes"]]
        self.temperature = float(nar["softmax_temperature"])
        self.t = int(nar["max_session_length"]) - 1
        self.item_emb = emb_dim(self.num_items, int(nar["item_embedding_const_mult"]))

    def tower_dim(self, feats) -> int:
        dim = 0
        for f in feats:
            if f.kind != "categorical":
                dim += 1
            elif f.card <= self.ohe_max:
                dim += f.card
            else:
                dim += emb_dim(f.card)
        return dim

    @property
    def user_dim(self) -> int:
        return self.tower_dim(self.ctx) if self.ctx else 1

    @property
    def item_dim(self) -> int:
        return self.tower_dim(self.meta) + self.ace_dim + self.item_emb + 2

    @property
    def feat_dim(self) -> int:
        return self.user_dim + self.item_dim

    def param_shapes(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """(name, shape, kind) of every parameter, under the system's names;
        kind is the initialiser's: he, glorot, lecun, ones or zeros."""
        out = []
        for prefix, feats in (("user_context_towers", self.ctx),
                              ("article_metadata_towers", self.meta)):
            for f in feats:
                if f.kind == "categorical" and f.card > self.ohe_max:
                    out.append((f"{prefix}.embeddings.{f.name}_embedding.weight",
                                (f.card, emb_dim(f.card)), "glorot"))
        c, u, fd = self.c, self.units, self.feat_dim
        out += [
            ("item_clicked_embedding.weight", (self.num_items, self.item_emb), "glorot"),
            ("gamma_scale", (fd,), "ones"),
            ("beta_center", (fd,), "zeros"),
            ("PreCAR_kernel", (fd, c), "he"),
            ("PreCAR_bias", (c,), "zeros"),
            ("CAR_kernel", (c, c), "glorot"),
            ("CAR_bias", (c,), "zeros"),
        ]
        for i in range(self.layers):
            width = c if i == 0 else u
            out += [
                (f"rnn.layers.{i}.input_proj.weight", (2 * u, width), "glorot"),
                (f"rnn.layers.{i}.input_proj.bias", (2 * u,), "zeros"),
                (f"rnn.layers.{i}.recurrent_kernel", (u, 2 * u), "glorot"),
            ]
        out += [
            ("session_FC1.weight", (512, u), "he_rows"),
            ("session_FC1.bias", (512,), "zeros"),
            ("session_FC2.weight", (c, 512), "glorot"),
            ("session_FC2.bias", (c,), "zeros"),
        ]
        width = c
        for i, m in enumerate(self.matching):
            out += [(f"matching_{i + 1}_kernel", (width, m), "he"),
                    (f"matching_{i + 1}_bias", (m,), "zeros")]
            width = m
        out += [("matching_out_kernel", (width, 1), "lecun"),
                ("matching_out_bias", (1,), "zeros")]
        return out


def regularized(name: str) -> bool:
    """Whether ``name`` carries the L2 term: dense kernels, embeddings and
    the scale/center vectors do; biases and the session RNN do not."""
    parts = name.split(".")
    if parts[0] == "rnn":
        return False
    return not any(p == "bias" or p.endswith("_bias") for p in parts)


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().max().clamp_min(1e-30)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def q(self, x):
        return _RoundFp8.apply(x) if self.name == "fp8" else x

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


def leaky(x):
    return F.leaky_relu(x, LEAKY)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

@dataclass
class Inputs:
    """The static inputs the benchmark made: ACEs [N, D] f32, article
    metadata columns, the click buffer and the normalised popularity."""

    ace: torch.Tensor
    metadata: Dict[str, torch.Tensor]
    buffer_ids: torch.Tensor
    pop_norm: torch.Tensor


def take(table, ids):
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def towers(model: Model, feats, values: Dict[str, torch.Tensor], params, prefix):
    chans = []
    for f in feats:
        x = values[f.name]
        if f.kind != "categorical":
            chans.append(x.float()[..., None])
        elif f.card <= model.ohe_max:
            chans.append((x[..., None] == torch.arange(f.card, device=x.device)).float())
        else:
            chans.append(take(params[f"{prefix}.embeddings.{f.name}_embedding.weight"], x))
    return torch.cat(chans, -1)


def _normalise(values, ids, stat_values, stat_mask):
    """z-norm against the buffer's statistics (or, with an empty buffer,
    the call's own non-padding values), then min-max into [-1, 1]."""
    empty = ~stat_mask.any()
    sv = torch.cat([stat_values, values.reshape(-1)])
    sm = torch.cat([stat_mask, (ids != 0).reshape(-1) & empty])
    w = sm.float()
    n = w.sum().clamp_min(1.0)
    mean = (sv * w).sum() / n
    std = torch.sqrt(((sv - mean) ** 2 * w).sum() / n + EPS)
    z = (values - mean) / std
    zs = (sv - mean) / std
    big = torch.finfo(torch.float32).max
    lo = torch.where(sm, zs, big).min()
    hi = torch.where(sm, zs, -big).max()
    return ((z - lo + EPS) / (hi - lo).clamp_min(2 * EPS) * 2.0 - 1.0)[..., None]


def dynamic(model: Model, ids, ref_ts, inp: Inputs):
    nar = model.nar
    stat_ids = inp.buffer_ids[: int(nar["recent_clicks_for_normalization"])]
    stat_mask = stat_ids != 0
    created = inp.metadata["created_at_ts"]
    base_r = math.log(float(nar["elapsed_days_smooth_log_base"]))
    ref = ref_ts.float()
    rec = torch.log(torch.relu((ref - take(created, ids).float()) / SECONDS_PER_DAY) + 1) / base_r
    stat_rec = torch.log(torch.relu((ref.max() - take(created, stat_ids).float())
                                    / SECONDS_PER_DAY) + 1) / base_r
    base_p = math.log(float(nar["popularity_smooth_log_base"]))
    nov = -torch.log(take(inp.pop_norm, ids)) / base_p
    stat_nov = -torch.log(take(inp.pop_norm, stat_ids)) / base_p
    return [_normalise(rec, ids, stat_rec, stat_mask),
            _normalise(nov, ids, stat_nov, stat_mask)]


def item_features(model: Model, ids, ref_ts, inp: Inputs, params):
    parts = []
    if model.meta:
        parts.append(towers(model, model.meta,
                            {f.name: take(inp.metadata[f.name], ids) for f in model.meta},
                            params, "article_metadata_towers"))
    parts.append(take(inp.ace, ids))
    parts.append(take(params["item_clicked_embedding.weight"], ids))
    return torch.cat(parts + dynamic(model, ids, ref_ts, inp), -1)


def car(params, x, prec: Precision):
    pre = leaky(prec.mm(x, params["PreCAR_kernel"]) + params["PreCAR_bias"])
    return torch.tanh(prec.mm(pre, params["CAR_kernel"]) + params["CAR_bias"])


def scale_center(params, x):
    return x * params["gamma_scale"] + params["beta_center"]


def match(model: Model, params, x, prec: Precision):
    for i in range(len(model.matching)):
        x = leaky(prec.mm(x, params[f"matching_{i + 1}_kernel"])
                  + params[f"matching_{i + 1}_bias"])
    return (prec.mm(x, params["matching_out_kernel"]) + params["matching_out_bias"])[..., 0]


def ugrnn(model: Model, params, x, mask, prec: Precision):
    u = model.units
    h_seq = x
    for i in range(model.layers):
        w_in = params[f"rnn.layers.{i}.input_proj.weight"]
        proj = prec.mm(h_seq, w_in.T) + params[f"rnn.layers.{i}.input_proj.bias"]
        w_hh = params[f"rnn.layers.{i}.recurrent_kernel"]
        h = x.new_zeros((x.shape[0], u))
        outs = []
        for t in range(x.shape[1]):
            a = proj[:, t] + prec.mm(h, w_hh)
            g = torch.sigmoid(a[:, :u] + FORGET_BIAS)
            c = torch.tanh(a[:, u:])
            h = torch.where(mask[:, t, None], g * h + (1 - g) * c, h)
            outs.append(h)
        h_seq = torch.stack(outs, 1)
    return h_seq * mask[..., None].float()


@dataclass
class Encoded:
    user_ctx: torch.Tensor  # [B, T, Fu]
    pos_car: torch.Tensor  # [B, T, C]
    pred: torch.Tensor  # [B, T, C]
    mask: torch.Tensor  # [B, T] bool
    max_ts: torch.Tensor  # []


def encode(model: Model, params, batch: Dict[str, torch.Tensor], inp: Inputs,
           prec: Precision) -> Encoded:
    clicked, labels = batch["item_clicked"], batch["label_next_item"]
    b, t = clicked.shape
    mask = torch.arange(t, device=clicked.device)[None] < (batch["session_size"].long() - 1)[:, None]
    ts = batch["event_timestamp"]
    max_ts = ts.max()
    if model.ctx:
        user = towers(model, model.ctx, {f.name: batch[f.name] for f in model.ctx},
                      params, "user_context_towers")
    else:
        user = torch.zeros((b, t, 1), device=clicked.device)
    x_in = scale_center(params, torch.cat([user, item_features(model, clicked, ts, inp, params)], -1))
    x_pos = scale_center(params, torch.cat([user, item_features(model, labels, max_ts, inp, params)], -1))
    in_car, pos_car = car(params, x_in, prec), car(params, x_pos, prec)
    rnn = ugrnn(model, params, in_car, mask, prec)
    h = leaky(prec.mm(rnn, params["session_FC1.weight"].T) + params["session_FC1.bias"])
    pred = torch.tanh(prec.mm(h, params["session_FC2.weight"].T) + params["session_FC2.bias"])
    return Encoded(user, pos_car, pred, mask, max_ts)


def candidate_logits(model: Model, params, user_ctx, pos_car, pred, cands, max_ts,
                     inp: Inputs, prec: Precision, block: int = 512):
    """[R, 1 + K] logits (score / temperature) of each row's label and its K
    candidate ids ``cands`` [R, K], every candidate through the whole CAR
    tower beside its row's user context; rows in blocks of ``block``."""
    pos = match(model, params, pos_car * pred, prec)
    out = []
    for lo in range(0, cands.shape[0], block):
        hi = lo + block
        ids = cands[lo:hi]
        feats = item_features(model, ids, max_ts, inp, params)
        ctx = user_ctx[lo:hi, None, :].expand(ids.shape + (user_ctx.shape[-1],))
        neg_car = car(params, scale_center(params, torch.cat([ctx, feats], -1)), prec)
        out.append(match(model, params, neg_car * pred[lo:hi, None, :], prec))
    return torch.cat([pos[:, None], torch.cat(out)], -1) / model.temperature


# ---------------------------------------------------------------------------
# the click stream
# ---------------------------------------------------------------------------

@dataclass
class Stream:
    buffer_ids: torch.Tensor  # newest first, 0-padded
    buffer_ts: torch.Tensor
    pop_norm: torch.Tensor


def empty_stream(model: Model, device) -> Stream:
    size = int(model.nar["recent_clicks_buffer_max_size"])
    return Stream(torch.zeros(size, dtype=torch.int64, device=device),
                  torch.zeros(size, dtype=torch.int64, device=device),
                  torch.full((model.num_items,), 1.0 / model.nar["recent_clicks_for_normalization"],
                             device=device))


def fold_clicks(model: Model, stream: Stream, ids, ts) -> Stream:
    """The stream after a batch of clicks [B, L] (row-major order is click
    order; 0 is padding): the batch's clicks newest first ahead of the
    buffered ones no older than an hour before the batch's first click,
    cut to the buffer's size; popularity recounted over the buffer."""
    nar = model.nar
    ids = ids.reshape(-1).long().flip(0)
    ts = ts.reshape(-1).long().flip(0)
    valid = ids != 0
    threshold = ts[valid].min() - int(round(nar["recent_clicks_buffer_hours"] * 3600))
    keep = (stream.buffer_ids != 0) & (stream.buffer_ts >= threshold)
    new_ids = torch.cat([ids[valid], stream.buffer_ids[keep]])
    new_ts = torch.cat([ts[valid], stream.buffer_ts[keep]])
    size = stream.buffer_ids.shape[0]
    buf_ids = torch.zeros(size, dtype=torch.int64, device=ids.device)
    buf_ts = torch.zeros_like(buf_ids)
    n = min(size, new_ids.shape[0])
    buf_ids[:n], buf_ts[:n] = new_ids[:n], new_ts[:n]
    inside = (buf_ids > 0) & (buf_ids < model.num_items)
    counts = torch.bincount(buf_ids[inside], minlength=model.num_items).float()
    pop = torch.clamp_min(counts / (counts.sum() + 1.0),
                          1.0 / nar["recent_clicks_for_normalization"])
    return Stream(buf_ids, buf_ts, pop)


def batch_clicks(batch):
    """The clicks a batch adds to the stream: its inputs and each session's
    last click, that one stamped with the session's latest time."""
    clicked = torch.cat([batch["item_clicked"], batch["label_last_item"]], 1).long()
    ts = batch["event_timestamp"].long()
    ts = torch.cat([ts, ts.max(1, keepdim=True).values], 1)
    return clicked, torch.where(clicked != 0, ts, 0)


def recent_distinct(buffer_ids, n: int):
    """The ``n`` most recent distinct ids of the buffer, 0-padded."""
    seen, out = set(), []
    for i in buffer_ids.tolist():
        if i != 0 and i not in seen:
            seen.add(i)
            out.append(i)
            if len(out) == n:
                break
    return out + [0] * (n - len(out))


# ---------------------------------------------------------------------------
# the train step's row selection and negatives, judged
# ---------------------------------------------------------------------------

def valid_rows(session_size, t: int, capacity: int):
    """The flat (session, step) rows that hold a click, in grid order, the
    first ``capacity`` of them."""
    valid = (torch.arange(t, device=session_size.device)[None]
             < (session_size.long() - 1)[:, None]).reshape(-1)
    return torch.nonzero(valid)[:, 0][:capacity]


def negative_faults(all_clicked, buffer_ids, negs, row_session, row_click, k: int) -> int:
    """How many rows break what a negative sample promises: a row with a
    click has ``k`` distinct non-zero negatives, none of them clicked in its
    session, each a click of the batch or of the buffer; a padding row has
    none."""
    negs = negs.long()
    universe = torch.unique(torch.cat([all_clicked.reshape(-1).long(), buffer_ids.long()]))
    universe = universe[universe != 0]
    sess = all_clicked.long()[row_session.long()]
    nz = negs != 0
    in_session = ((negs[:, :, None] == sess[:, None, :]) & nz[:, :, None]).any(-1).any(-1)
    srt = torch.sort(negs, 1).values
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != 0)).any(-1)
    outside = (nz & ~torch.isin(negs, universe)).any(-1)
    live = row_click.long() != 0
    count_bad = torch.where(live, nz.sum(1) != k, nz.any(1))
    bad = in_session | dup | outside | count_bad
    return int(bad.sum())


# ---------------------------------------------------------------------------
# training: loss, gradient, Adam
# ---------------------------------------------------------------------------

def train_loss(model: Model, params, batch, inp: Inputs, rows, negs, prec: Precision):
    """(loss with the L2 term, cross-entropy, [M, 1 + K] probabilities) of
    one train batch scored over its valid ``rows`` with negatives ``negs``
    [M, K]."""
    enc = encode(model, params, batch, inp, prec)

    def sel(x):
        return x.reshape((-1,) + x.shape[2:])[rows]

    logits = candidate_logits(model, params, sel(enc.user_ctx), sel(enc.pos_car),
                              sel(enc.pred), negs, enc.max_ts, inp, prec)
    probs = torch.softmax(logits, -1)
    denom = enc.mask.float().sum().clamp_min(1.0)
    ce = -torch.log(probs[:, 0] + EPS).sum() / denom
    reg = sum((p.square().sum() / 2 for n, p in params.items() if regularized(n)),
              torch.zeros((), device=probs.device))
    loss = ce + float(model.nar["reg_weight_decay"]) * reg
    return loss, ce, probs


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, no weight decay), one leaf at a time."""

    def __init__(self, params, lr: float):
        self.lr = lr
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n, p in params.items():
            g = grads[n]
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[n] / (1 - b1 ** self.t)
            vhat = self.v[n] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + eps))


def train_steps(model: Model, params0: Dict[str, torch.Tensor], batches: Sequence[dict],
                steps_rows: Sequence[torch.Tensor],
                steps_negs: Sequence[torch.Tensor], stream: Stream, inp: Inputs,
                prec: Precision):
    """Run the steps the system ran: each batch's loss and probabilities,
    its gradient, Adam.  Returns (losses [ce per step], probabilities per
    step, the first step's gradient by leaf, the parameters after the
    last step)."""
    params = {n: p.detach().clone().requires_grad_(True) for n, p in params0.items()}
    adam = Adam(params, float(model.nar["learning_rate"]))
    losses, probs_all, first_grad = [], [], None
    for batch, rows, negs in zip(batches, steps_rows, steps_negs):
        step_inp = Inputs(inp.ace, inp.metadata, stream.buffer_ids, stream.pop_norm)
        loss, ce, probs = train_loss(model, params, batch, step_inp, rows, negs, prec)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for (n, p), g in zip(params.items(), grads)}
        if first_grad is None:
            first_grad = {n: g.detach().clone() for n, g in grads.items()}
        adam.step(params, grads)
        losses.append(float(ce.detach()))
        probs_all.append(probs.detach())
        stream = fold_clicks(model, stream, *batch_clicks(batch))
    return losses, probs_all, first_grad, {n: p.detach() for n, p in params.items()}


def serve_logits(model: Model, params, batch, cands, inp: Inputs, prec: Precision):
    """[B, 1 + K] logits of a serving batch: each session scored at its last
    click against the candidates ``cands`` [B, K] (the label slot holds
    article 0, as the serving collation leaves it)."""
    enc = encode(model, params, batch, inp, prec)
    rows = torch.arange(enc.pred.shape[0], device=enc.pred.device)
    pos = (batch["session_size"].long() - 2).clamp_min(0)
    return candidate_logits(model, params, enc.user_ctx[rows, pos], enc.pos_car[rows, pos],
                            enc.pred[rows, pos], cands, enc.max_ts, inp, prec)


def grid_logits(model: Model, params, batch, negs, inp: Inputs, prec: Precision):
    """[B, T, 1 + K] logits of every (session, step) of an eval batch with
    its negatives ``negs`` [B, T, K]."""
    enc = encode(model, params, batch, inp, prec)
    b, t, _ = enc.pred.shape
    flat = lambda x: x.reshape((b * t,) + x.shape[2:])  # noqa: E731
    logits = candidate_logits(model, params, flat(enc.user_ctx), flat(enc.pos_car),
                              flat(enc.pred), flat(negs), enc.max_ts, inp, prec)
    return logits.reshape(b, t, -1), enc.mask


def as_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def serving_batch(model: Model, sessions: Sequence[dict]) -> Dict[str, np.ndarray]:
    """Serving collation: every click of a session is an input (its last
    ``T`` clicks), the label slots hold article 0."""
    t, b = model.t, len(sessions)
    out = {"item_clicked": np.zeros((b, t), np.int64),
           "label_next_item": np.zeros((b, t), np.int64),
           "event_timestamp": np.zeros((b, t), np.int64),
           "session_size": np.zeros((b,), np.int64)}
    for f in model.ctx:
        out[f.name] = np.zeros((b, t), np.float32 if f.kind != "categorical" else np.int64)
    for i, s in enumerate(sessions):
        items = list(s["items"])[-t:]
        n = len(items)
        out["item_clicked"][i, :n] = items
        out["event_timestamp"][i, :n] = list(s["ts"])[-t:]
        out["session_size"][i] = n + 1
        for f in model.ctx:
            out[f.name][i, :n] = list(s["ctx"][f.name])[-t:]
    return out


def train_batch(model: Model, sessions: Sequence[dict], batch_size: int) -> Dict[str, np.ndarray]:
    """Training and eval collation: a session's first ``T + 1`` clicks, the
    inputs all but the last, the labels all but the first, the last click
    apart; ``batch_size`` rows, empty past the sessions."""
    t, b = model.t, batch_size
    out = {"item_clicked": np.zeros((b, t), np.int64),
           "label_next_item": np.zeros((b, t), np.int64),
           "label_last_item": np.zeros((b, 1), np.int64),
           "event_timestamp": np.zeros((b, t), np.int64),
           "session_size": np.zeros((b,), np.int64)}
    for f in model.ctx:
        out[f.name] = np.zeros((b, t), np.float32 if f.kind != "categorical" else np.int64)
    for i, s in enumerate(sessions):
        items = list(s["items"])[:t + 1]
        n = len(items)
        out["item_clicked"][i, :n - 1] = items[:-1]
        out["label_next_item"][i, :n - 1] = items[1:]
        out["label_last_item"][i, 0] = items[-1]
        out["event_timestamp"][i, :n - 1] = list(s["ts"])[:n - 1]
        out["session_size"][i] = n
        for f in model.ctx:
            out[f.name][i, :n - 1] = list(s["ctx"][f.name])[:n - 1]
    return out
