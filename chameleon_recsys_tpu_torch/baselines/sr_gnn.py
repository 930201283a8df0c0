"""SR-GNN, the port of ``chameleon_recsys_tpu/baselines/sr_gnn.py`` (the
reference bundles a TF1 implementation,
nar_module/nar/benchmarks/sr-gnn/gnn_ml_fast.py, utils.py).

Semantics are the JAX package's:
  * a graph per session: nodes are its unique items, edges its consecutive
    clicks, the in/out adjacency normalised by degree (``build_session_graphs``,
    numpy, at collation; dense [B, N, N] with N the session length);
  * gated propagation: messages ``[A_in (X W_in + b_in) || A_out (X W_out +
    b_out)]`` into a GRU cell, ``steps`` times; the cell (``_gru_cell``) has one
    bias per gate and the candidate's bias outside the ``r * (h W_hn)``
    product, so it is written by hand rather than taken from ``nn.GRUCell``;
  * the attention readout ``coef = v . sigma(W1 h_last + W2 h_pos + b)``, the
    session embedding ``sum coef h_pos`` (nonhybrid);
  * logits against the candidates' embeddings; softmax cross-entropy over
    ``[target || shared negatives]`` plus ``l2 * sum ||p||^2 / 2`` over every
    parameter; Adam with a staircase decay of the rate, by hand as optax
    computes it (``_OptaxAdam``).

Negatives come from the numpy ``RandomState`` the adapter holds, so the port
draws what JAX draws.  The JAX adapter padded its per-click rows to a
multiple of 256 so that its scoring program would not recompile; that
padding has no counterpart and the ranked output is the same.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .gru4rec import to_device

_PARAMS = ("embedding", "w_in", "b_in", "w_out", "b_out", "gru_wx", "gru_wh",
           "gru_b", "nasr_w1", "nasr_w2", "nasr_v", "nasr_b")


class SRGNNParams(nn.Module):
    """The JAX ``SRGNNParams``, in its order: ``embedding`` [n_items, d],
    ``w_in``/``w_out`` [d, d] with ``b_in``/``b_out`` [d], ``gru_wx`` [2d, 3d],
    ``gru_wh`` [d, 3d], ``gru_b`` [3d] (gates r, z, n), ``nasr_w1``/``nasr_w2``
    [d, d], ``nasr_v`` and ``nasr_b`` [d]."""

    def __init__(self, n_items: int, hidden: int):
        super().__init__()
        d = hidden
        shapes = {"embedding": (n_items, d), "w_in": (d, d), "b_in": (d,),
                  "w_out": (d, d), "b_out": (d,), "gru_wx": (2 * d, 3 * d),
                  "gru_wh": (d, 3 * d), "gru_b": (3 * d,), "nasr_w1": (d, d),
                  "nasr_w2": (d, d), "nasr_v": (d,), "nasr_b": (d,)}
        for name in _PARAMS:
            self.register_parameter(name, nn.Parameter(torch.empty(shapes[name])))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The reference's init: U(+-1/sqrt(d)), ``gru_b`` zero."""
        stdv = 1.0 / math.sqrt(self.embedding.shape[1])
        for name in _PARAMS:
            if name == "gru_b":
                self.gru_b.zero_()
            else:
                getattr(self, name).uniform_(-stdv, stdv, generator=generator)


def build_session_graphs(sessions_items: np.ndarray):
    """[B, T] padded click sequences -> (nodes, adj_in, adj_out, alias).

    nodes: [B, T] unique items (0-padded); adjacency normalized like the
    reference (utils.py:106-118); alias: [B, T] position -> node index.
    """
    b, t = sessions_items.shape
    nodes = np.zeros((b, t), np.int64)
    adj = np.zeros((b, t, t), np.float32)
    alias = np.zeros((b, t), np.int64)
    for i in range(b):
        seq = sessions_items[i]
        uniq = np.unique(seq[seq != 0])
        nodes[i, : len(uniq)] = uniq
        node_index = {item: idx for idx, item in enumerate(uniq)}
        for pos in range(t - 1):
            if seq[pos] == 0 or seq[pos + 1] == 0:
                continue
            adj[i, node_index[seq[pos]], node_index[seq[pos + 1]]] = 1.0
        for pos in range(t):
            alias[i, pos] = node_index.get(seq[pos], 0)
    sum_in = adj.sum(axis=1, keepdims=True)
    sum_in[sum_in == 0] = 1.0
    adj_in = adj / sum_in
    sum_out = adj.sum(axis=2, keepdims=True)
    sum_out[sum_out == 0] = 1.0
    adj_out = np.swapaxes(adj / sum_out, 1, 2)
    return nodes, adj_in, adj_out, alias


def _gru_cell(h, x, wx, wh, b, d):
    gates_x = x @ wx
    gates_h = h @ wh
    r = torch.sigmoid(gates_x[:, :d] + gates_h[:, :d] + b[:d])
    z = torch.sigmoid(gates_x[:, d: 2 * d] + gates_h[:, d: 2 * d] + b[d: 2 * d])
    n = torch.tanh(gates_x[:, 2 * d:] + r * gates_h[:, 2 * d:] + b[2 * d:])
    return (1.0 - z) * n + z * h


def _propagate(params: SRGNNParams, nodes, adj_in, adj_out, steps: int):
    """Gated graph propagation over node states [B, N, d]."""
    d = params.embedding.shape[1]
    h = params.embedding[nodes]
    for _ in range(steps):
        msg_in = adj_in @ (h @ params.w_in + params.b_in)
        msg_out = adj_out @ (h @ params.w_out + params.b_out)
        av = torch.cat([msg_in, msg_out], dim=-1)  # [B, N, 2d]
        b_, n_, _ = av.shape
        h = _gru_cell(h.reshape(-1, d), av.reshape(-1, 2 * d), params.gru_wx,
                      params.gru_wh, params.gru_b, d).reshape(b_, n_, d)
    return h


def _session_embedding(params: SRGNNParams, h, alias, mask):
    """Attention readout (gnn_ml_fast.py:31-52, nonhybrid)."""
    d = h.shape[-1]
    seq_h = torch.gather(h, 1, alias[..., None].expand(-1, -1, d))  # [B, T, d]
    lengths = mask.sum(1).clamp(min=1)
    last_h = seq_h[torch.arange(seq_h.shape[0], device=h.device), lengths - 1]
    m = torch.sigmoid((last_h @ params.nasr_w1)[:, None, :] + seq_h @ params.nasr_w2
                      + params.nasr_b)
    coef = (m @ params.nasr_v) * mask.float()  # [B, T]
    return (coef[..., None] * seq_h).sum(1)  # [B, d]


class _OptaxAdam(torch.optim.Optimizer):
    """``optax.adam(optax.exponential_decay(lr, lr_dc_steps, lr_dc,
    staircase=True))`` by hand, in optax's order of operations: the moments,
    their bias correction at the incremented count, ``m / (sqrt(v) + eps)``,
    then ``p += -rate * update`` with the rate taken at the count before the
    step."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults, which SR-GNN uses

    def __init__(self, params, lr: float, lr_dc: float, lr_dc_steps: int):
        super().__init__(params, dict(lr=lr, lr_dc=lr_dc, lr_dc_steps=lr_dc_steps))
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        count = self.count + 1
        b1, b2 = self.b1, self.b2
        for group in self.param_groups:
            scale = -group["lr"] * group["lr_dc"] ** (self.count // group["lr_dc_steps"])
            for p in group["params"]:
                g = p.grad
                state = self.state[p]
                mu = state.setdefault("mu", torch.zeros_like(p))
                nu = state.setdefault("nu", torch.zeros_like(p))
                mu.mul_(b1).add_((1.0 - b1) * g)
                nu.mul_(b2).add_((1.0 - b2) * g.square())
                update = (mu / (1.0 - b1 ** count)) / (
                    (nu / (1.0 - b2 ** count)).sqrt_() + self.eps)
                p.add_(update.mul_(scale))
        self.count = count


class SRGNN:
    """The session-graph recommender (the JAX ``SRGNNJax``) with the
    framework's padded-batch contract, on ``device``: it scores the LAST
    click of each session, ranking ``[label || negatives]``."""

    def __init__(
        self,
        n_items: int,
        hidden_size: int = 100,
        steps: int = 1,
        lr: float = 1e-3,
        l2: float = 1e-5,
        lr_dc: float = 0.1,
        lr_dc_steps: int = 3000,
        seed: int = 42,
        device="cuda",
    ):
        self.n_items = n_items
        self.hidden = hidden_size
        self.steps = steps
        self.l2 = l2
        self.device = torch.device(device)
        params = SRGNNParams(n_items, hidden_size)
        params.reset_parameters(torch.Generator().manual_seed(seed))
        self.params = params.to(self.device)
        self.optimizer = _OptaxAdam(self.params.parameters(), lr, lr_dc, lr_dc_steps)

    def _graphs(self, sessions_items):
        nodes, adj_in, adj_out, alias = build_session_graphs(sessions_items)
        dev = self.device
        return (to_device(nodes, dev), to_device(adj_in, dev, torch.float32),
                to_device(adj_out, dev, torch.float32), to_device(alias, dev),
                to_device(sessions_items != 0, dev, torch.bool))

    def logits(self, nodes, adj_in, adj_out, alias, mask, candidates):
        h = _propagate(self.params, nodes, adj_in, adj_out, self.steps)
        sess_emb = _session_embedding(self.params, h, alias, mask)
        return torch.einsum("bd,bcd->bc", sess_emb, self.params.embedding[candidates])

    def loss(self, graphs, target, neg_sample):
        """(cross-entropy + l2 * sum ||p||^2 / 2, the cross-entropy)."""
        cand = torch.cat([target[:, None], neg_sample.expand(target.shape[0], -1)], dim=1)
        log_probs = F.log_softmax(self.logits(*graphs, cand), dim=1)
        w = (target != 0).float()
        xe = (-log_probs[:, 0] * w).sum() / w.sum().clamp(min=1.0)
        l2 = sum(p.square().sum() / 2.0 for p in self.params.parameters())
        return xe + self.l2 * l2, xe

    def fit_batch(self, sessions_items: np.ndarray, targets: np.ndarray,
                  buffer_ids: np.ndarray, n_sample: int = 200,
                  rng: Optional[np.random.RandomState] = None) -> torch.Tensor:
        """One step on sessions_items [B, T] (inputs) and targets [B] (the
        last labels); the cross-entropy as a device scalar."""
        rng = rng or np.random.RandomState(0)
        nonzero = buffer_ids[buffer_ids != 0]
        if len(nonzero) == 0:
            nonzero = np.array([1])
        neg = rng.choice(nonzero, size=n_sample)
        total, xe = self.loss(self._graphs(sessions_items), to_device(targets, self.device),
                              to_device(neg, self.device))
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        return xe.detach()

    def rank_candidates(self, sessions_items: np.ndarray, targets: np.ndarray,
                        neg_items: np.ndarray) -> np.ndarray:
        """Ranked [B, 1 + K] candidate ids for the last click of each session."""
        candidates = np.concatenate([targets[:, None], neg_items], axis=1)
        with torch.no_grad():
            scores = self.logits(*self._graphs(sessions_items),
                                 to_device(candidates, self.device)).cpu().numpy()
        scores = np.where(candidates == 0, -np.inf, scores)
        order = np.argsort(-scores, axis=1, kind="stable")
        return np.take_along_axis(candidates, order, axis=1)


class SRGNNSessionAdapter:
    """SR-GNN on the framework's per-click [B, T] eval contract: training on
    full sessions with the last label as target; ranking every valid click
    from the graph of its session's prefix (the reference's run_sr_gnn.py
    protocol)."""

    recommender_name = "sr-gnn"  # the CSV column suffix (the reference's naming)

    def __init__(self, model: SRGNN, n_sample: int = 200, seed: int = 0):
        self.model = model
        self.n_sample = n_sample
        self.rng = np.random.RandomState(seed)

    def fit_batch(self, items: np.ndarray, labels: np.ndarray, buffer_ids):
        lengths = (labels != 0).sum(axis=1)
        valid = lengths > 0
        if not valid.any():
            return 0.0
        targets = np.zeros(len(labels), np.int64)
        targets[valid] = labels[np.arange(len(labels))[valid], lengths[valid] - 1]
        return self.model.fit_batch(items, targets, np.asarray(buffer_ids),
                                    n_sample=self.n_sample, rng=self.rng)

    def rank_candidates(self, items, labels, neg_items):
        b, t = labels.shape
        k = neg_items.shape[-1]
        rows, cols = np.nonzero(labels)
        if len(rows) == 0:
            return np.zeros((b, t, 1 + k), np.int64)
        prefixes = np.zeros((len(rows), t), np.int64)
        for n, (r, c) in enumerate(zip(rows, cols)):
            prefixes[n, : c + 1] = items[r, : c + 1]
        ranked = np.zeros((b, t, 1 + k), np.int64)
        ranked[rows, cols] = self.model.rank_candidates(
            prefixes, labels[rows, cols].astype(np.int64), neg_items[rows, cols])
        return ranked
