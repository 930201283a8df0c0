"""Serving: next-article recommendations for live sessions.

Port of ``chameleon_recsys_tpu/serve.py::NARServer``.  ``recommend`` scores
candidates at each session's last valid position and returns the top k;
``observe`` folds served sessions' clicks into the streaming state so the
popularity and recency features track the live stream.

  * serving collation treats every click as an input; the next click is the
    prediction target, so the label slot holds item 0;
  * candidates default to the click buffer's most recent distinct items;
  * a candidate id 0 is padding and scores -inf.

With ``cfg.use_pallas_rnn`` the session RNN runs through the hand-written
CUDA kernel, two launches per ``recommend`` at two layers.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ArticleFeaturesSchema, NARConfig, SessionFeaturesSchema
from .data.collate import Session
from .models.nar import NARAux, NARModel
from .state.stream_state import StreamState, update_stream_state


class NARServer:
    def __init__(
        self,
        cfg: NARConfig,
        session_schema: SessionFeaturesSchema,
        article_schema: ArticleFeaturesSchema,
        params: Mapping[str, torch.Tensor],
        stream: StreamState,
        ace_matrix,
        metadata: Dict[str, np.ndarray],
        device="cuda",
    ):
        self.cfg = cfg
        self.session_schema = session_schema
        self.article_schema = article_schema
        self.device = torch.device(device)
        ace = torch.as_tensor(np.asarray(ace_matrix), dtype=torch.float32)
        self.ace_matrix = ace.to(self.device)
        self.metadata = {
            name: torch.as_tensor(
                np.asarray(col, np.float32 if np.asarray(col).dtype.kind == "f"
                           else np.int64),
                device=self.device,
            )
            for name, col in dict(metadata).items()
        }
        self.model = NARModel(cfg, session_schema, article_schema, ace.shape[1])
        self.model.load_state_dict(params, strict=True)
        self.model.to(self.device).eval()
        self.stream = StreamState(*(x.to(self.device) for x in stream))

    # ------------------------------------------------------------------
    def _collate_serving(self, sessions: Sequence[Session]) -> Dict[str, torch.Tensor]:
        """Serving collation: ALL clicks are inputs (no label shift)."""
        t = self.cfg.max_inputs_length
        b = len(sessions)
        batch = {
            "item_clicked": np.zeros((b, t), np.int32),
            "label_next_item": np.zeros((b, t), np.int32),
            "event_timestamp": np.zeros((b, t), np.int32),
            "session_size": np.zeros((b,), np.int32),
        }
        ctx_specs = self.session_schema.context_sequence_features()
        for spec in ctx_specs:
            dtype = np.float32 if spec.dtype == "float" else np.int32
            batch[spec.name] = np.zeros((b, t), dtype)
        for i, s in enumerate(sessions):
            items = s.item_ids[-t:]  # the most recent clicks fit the window
            n = len(items)
            batch["item_clicked"][i, :n] = items
            batch["event_timestamp"][i, :n] = s.timestamps[-t:]
            batch["session_size"][i] = n + 1  # all n clicks are inputs
            for spec in ctx_specs:
                vals = s.context.get(spec.name, [0] * n)[-t:]
                batch[spec.name][i, : len(vals)] = vals
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    @torch.inference_mode()
    def _score(self, batch, candidates: torch.Tensor, top_k: int):
        aux = NARAux(
            ace_matrix=self.ace_matrix,
            metadata=self.metadata,
            recent_pop_norm=self.stream.recent_pop_norm,
            buffer_ids=self.stream.buffer_ids,
        )
        # position t predicts click t+1: score at each session's last click
        last_pos = torch.clamp_min(batch["session_size"].long() - 2, 0)
        items_prob = self.model(
            batch, aux, candidates[:, None, :], candidate_positions=last_pos
        )
        cand_probs = items_prob[:, 0, 1:]  # [B, C]; label slot dropped
        cand_probs = torch.where(candidates != 0, cand_probs, -torch.inf)
        top_scores, top_idx = torch.topk(cand_probs, top_k, dim=1)
        return torch.gather(candidates, 1, top_idx), top_scores

    def default_candidates(self, num_candidates: int) -> np.ndarray:
        """Most recent distinct items from the live buffer."""
        buffer_ids = self.stream.buffer_ids.cpu().numpy()
        nonzero = buffer_ids[buffer_ids != 0]
        _, first_idx = np.unique(nonzero, return_index=True)
        recent_distinct = nonzero[np.sort(first_idx)][:num_candidates]
        out = np.zeros(num_candidates, np.int32)
        out[: len(recent_distinct)] = recent_distinct
        return out

    def recommend(
        self,
        sessions: Sequence[Session],
        candidates: Optional[np.ndarray] = None,
        top_k: int = 10,
        num_candidates: int = 500,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k next-article recommendations per session: (ids [B, top_k]
        int32, scores [B, top_k] f32), ordered by the model's softmax over
        the candidate set.  Ties in score come in no promised order."""
        if len(sessions) == 0:
            return (np.zeros((0, top_k), np.int32),
                    np.zeros((0, top_k), np.float32))
        if candidates is None:
            pool = self.default_candidates(num_candidates)
            candidates = np.broadcast_to(pool, (len(sessions), len(pool)))
        cand = torch.from_numpy(np.array(candidates, np.int32))  # a writable copy
        ids, scores = self._score(
            self._collate_serving(sessions), cand.to(self.device), top_k
        )
        return ids.cpu().numpy(), scores.cpu().numpy()

    def observe(self, sessions: Sequence[Session]) -> None:
        """Fold served sessions' clicks into the streaming state."""
        if not sessions:
            return
        max_len = max(len(s.item_ids) for s in sessions)
        b = len(sessions)
        ids = np.zeros((b, max_len), np.int32)
        ts = np.zeros((b, max_len), np.int32)
        for i, s in enumerate(sessions):
            ids[i, : len(s.item_ids)] = s.item_ids
            ts[i, : len(s.timestamps)] = s.timestamps
        self.stream = update_stream_state(
            self.stream,
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(ts).to(self.device),
            self.cfg,
        )
