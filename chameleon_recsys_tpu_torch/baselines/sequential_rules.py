"""SR — Sequential Rules (Ludewig & Jannach 2018)
(reference nar_module/nar/benchmarks/sequential_rules.py:16-94):
``rules[past_item][active_item] += decay(click_distance)`` with a max
walk-back of ``max_clicks_dist`` clicks; predictions rank an item's rule
targets by accumulated score.

The port's copy of ``chameleon_recsys_tpu/baselines/sequential_rules.py``,
unchanged but for this note: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from .benchmarks import BenchmarkRecommender, fill_ranked_topk, topk_by_key

DECAY_FNS = {
    "same": lambda i: 1.0,
    "div": lambda i: 1.0 / i,
    "linear": lambda i: 1.0 - 0.1 * i if i <= 100 else 0.0,
    "log": lambda i: 1.0 / math.log10(i + 1.7),
    "quadratic": lambda i: 1.0 / (i * i),
}


class SequentialRulesRecommender(BenchmarkRecommender):
    def __init__(self, state_view, params, streaming_metrics):
        super().__init__(state_view, params, streaming_metrics)
        self.max_clicks_dist = params["max_clicks_dist"]
        self.decay_fn = DECAY_FNS[params["dist_between_clicks_decay"]]
        states = state_view.benchmarks_states
        if self.get_clf_suffix() not in states:
            states[self.get_clf_suffix()] = {"rules": defaultdict(dict)}

    @property
    def rules(self):
        # read through the host state EVERY access (never cache the dict):
        # save/restore_state_checkpoint REBINDS benchmarks_states around each
        # eval hour, and a cached reference would keep eval-hour pollution
        states = self.state_view.benchmarks_states
        if self.get_clf_suffix() not in states:
            states[self.get_clf_suffix()] = {"rules": defaultdict(dict)}
        return states[self.get_clf_suffix()]["rules"]

    def get_clf_suffix(self):
        return "sr"

    def get_description(self):
        return "Sequential Rules"

    @staticmethod
    def _full_session_clicks(sessions_items, sessions_next_items):
        """Inputs + the final label, padding stripped
        (reference sequential_rules.py:44-50)."""
        out = []
        for inputs, nexts in zip(sessions_items, sessions_next_items):
            clicks = [int(x) for x in inputs if x != 0]
            next_nonzero = [int(x) for x in nexts if x != 0]
            if next_nonzero:
                clicks = clicks + [next_nonzero[-1]]
            if clicks:
                out.append(clicks)
        return out

    def train(self, users_ids, sessions_ids, sessions_items, sessions_next_items):
        for clicks in self._full_session_clicks(sessions_items, sessions_next_items):
            for i in range(1, len(clicks)):
                active = clicks[i]
                for j in range(max(0, i - self.max_clicks_dist), i):
                    past = clicks[j]
                    score = self.rules[past].get(active, 0.0)
                    self.rules[past][active] = score + self.decay_fn(i - j)

    def predict(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Per-click rule lookup (dicts are the rule store), but the
        filter-to-valid + rank step is the shared batched kernel.  Ties order
        by ascending id — the scalar oracle's tie order is the arbitrary
        rule-dict insertion order (the reference shares this arbitrariness,
        sequential_rules.py:84-94), so outputs can differ between the two
        paths only where two rule targets have exactly equal scores."""
        sessions_items = np.asarray(sessions_items)
        valid_items = np.asarray(valid_items)
        rules = self.rules
        keys = np.full(valid_items.shape, np.inf)
        rows, cols = np.nonzero(sessions_items)
        if len(rows) == 0:
            return topk_by_key(sessions_items, valid_items, keys, topk)
        # group clicks by active item: each touched rule dict is converted
        # to sorted (target, score) arrays ONCE per batch, then every click
        # sharing the item scores its valid row with one searchsorted —
        # presence = dict membership ("linear" decay can store 0.0 or
        # negative rule scores, which the ranking still includes)
        active = sessions_items[rows, cols]
        order = np.argsort(active, kind="stable")
        bounds = np.nonzero(np.diff(active[order]))[0] + 1
        for g in np.split(order, bounds):
            targets = rules.get(int(active[g[0]]))
            if not targets:
                continue
            t_ids = np.fromiter(targets.keys(), np.int64, len(targets))
            t_scores = np.fromiter(targets.values(), np.float64, len(targets))
            srt = np.argsort(t_ids)
            t_ids, t_scores = t_ids[srt], t_scores[srt]
            vi = valid_items[rows[g], cols[g]]  # [n_group, C]
            pos = np.minimum(np.searchsorted(t_ids, vi), t_ids.size - 1)
            hit = t_ids[pos] == vi
            keys[rows[g], cols[g]] = np.where(hit, -t_scores[pos], np.inf)
        return topk_by_key(sessions_items, valid_items, keys, topk)

    def _predict_scalar(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Per-click transliteration — the oracle for ``predict`` (tie order
        excepted, see predict)."""
        preds = np.zeros(
            (sessions_items.shape[0], sessions_items.shape[1], topk), np.int64
        )
        for r, c, item in self._valid_click_coords(sessions_items):
            targets = self.rules.get(item, {})
            ranked = sorted(targets, key=lambda k: -targets[k])
            preds[r, c] = fill_ranked_topk(ranked, valid_items[r, c], topk)
        return preds
