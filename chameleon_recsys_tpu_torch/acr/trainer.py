"""ACR training driver: train the ACE side task, export the ACE matrix
(port of ``chameleon_recsys_tpu/acr/trainer.py``).

Re-creation of the reference ACR trainers
(acr_module/acr/acr_trainer_gcom.py:1-352, acr_trainer_adressa.py:1-408):

  * train N epochs on the article corpus (metadata classification, or the
    denoising autoencoder);
  * evaluate on the train set: "the objective is to overfit"
    (acr_trainer_adressa.py:368-375);
  * predict an ACE for every article, sorted by article id;
  * assemble the [num_articles + 1, acr_dim] matrix with the padding row 0
    set to the mean embedding (acr_trainer_adressa.py:264-297) and export the
    ``(label_encoders, metadata, ace_matrix)`` pickle, the NAR handoff
    artifact (acr_trainer_adressa.py:250-254).

As the JAX trainer: Adam (optax's defaults, eps 1e-8), the L2 term
(``l2_reg_lambda`` times half the squared sum of every non-bias parameter)
inside the loss, the tail batch padded with row 0 at weight 0, one
``RandomState(0)`` shuffling every epoch; for the autoencoder the decoder's
special token drawn from ``RandomState(seed)`` and optax's
``clip_by_global_norm(5.0)`` before Adam (``_clip_by_global_norm``).  The
dropout masks and the autoencoder's noise come from ``self.generator``
(seeded with ``seed``).  The corpus moves to the device once; a step
indexes it there, and the losses stay on the device until the epoch's end
(one fetch an epoch).  The steps run in float32 with TF32 off
(``torch.backends.cudnn.allow_tf32`` and ``cuda.matmul.allow_tf32``), as
the JAX package's f32 ACR computes.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ACRConfig
from ..models.acr import ACRAutoencoderModel, ACRClassifierModel, ACRLabelSpec
from ..utils.io import deserialize, serialize

log = logging.getLogger("chameleon_tpu.acr")


def _epoch_plan(n: int, batch_size: int, shuffle_rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX trainer's ``_batched`` order of one epoch, laid end to end:
    the row indices and weights of ``ceil(n / batch_size)`` batches
    (optionally shuffled by ``shuffle_rng``), the tail batch padded with row
    0 at weight 0 (static shapes)."""
    rows = np.arange(n)
    if shuffle_rng is not None:
        shuffle_rng.shuffle(rows)
    pad = -n % batch_size
    weights = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return np.concatenate([rows, np.zeros(pad, rows.dtype)]), weights


def _clip_by_global_norm(params, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the gradients of ``params``, in
    place: where the global norm is at least ``max_norm`` every gradient
    becomes ``g / norm * max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


@contextlib.contextmanager
def _full_f32():
    """float32 products and convolutions in full f32 (no TF32) on the card."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class ACRTrainer:
    """ACR driver over in-memory article arrays.

    ``articles`` columns: 'article_id' [N], 'text' [N, L] int32 token ids,
    'text_length' [N], plus one column per label head.  The model is built
    and initialised from ``seed`` at construction (``self.model``; load
    other weights into it before ``fit``).
    """

    def __init__(
        self,
        cfg: ACRConfig,
        word_embeddings: np.ndarray,
        label_specs: Tuple[ACRLabelSpec, ...] = (),
        label_class_weights: Optional[Dict[str, np.ndarray]] = None,
        seed: int = 42,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.label_specs = tuple(label_specs)
        self.autoencoder = cfg.training_task == "autoencoder"
        if self.autoencoder:
            self.model = ACRAutoencoderModel(cfg, word_embeddings)
            # the decoder's seed token ~ U(-0.04, 0.04)
            # (acr_trainer_adressa.py:338-339)
            self.special_token_embedding = torch.as_tensor(
                np.random.RandomState(seed).uniform(
                    -0.04, 0.04, size=(1, cfg.word_embedding_size)),
                dtype=torch.float32, device=self.device)
        else:
            self.model = ACRClassifierModel(cfg, self.label_specs, word_embeddings)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        # dropout masks and the autoencoder's noise
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.label_class_weights = (
            {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
             for k, v in label_class_weights.items()}
            if label_class_weights else None
        )
        # optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8); the L2 term is
        # in the loss, not Adam's weight decay
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=cfg.learning_rate, eps=1e-8)

    # -- forward/step -------------------------------------------------------
    def _labels(self, batch):
        return {s.name: batch[s.name] for s in self.label_specs}

    def _l2(self) -> torch.Tensor:
        total = sum((p.float().square().sum() / 2.0
                     for name, p in self.model.named_parameters() if "bias" not in name),
                    torch.zeros((), device=self.device))
        return self.cfg.l2_reg_lambda * total

    def _task_loss(self, batch, weights) -> torch.Tensor:
        if self.autoencoder:
            return self.model(batch["text"], self.special_token_embedding, weights,
                              train=True, generator=self.generator)[2]
        return self.model(batch["text"], self._labels(batch), self.label_class_weights,
                          example_weights=weights, train=True,
                          generator=self.generator).loss

    def train_step(self, batch: Dict[str, torch.Tensor], weights: torch.Tensor):
        """One Adam step on a device batch (the autoencoder's gradients
        clipped to a global norm of 5 first, acr_model.py:519); returns
        (loss, task loss) as device scalars.  The model is put in training
        mode: cuDNN's RNN backward runs only there."""
        self.model.train()
        task_loss = self._task_loss(batch, weights)
        loss = task_loss + self._l2()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.autoencoder:
            _clip_by_global_norm(self.model.parameters(), 5.0)
        self.optimizer.step()
        return loss.detach(), task_loss.detach()

    def _device_columns(self, articles: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in articles.items()}

    def _device_batches(self, columns, plan):
        """(batch, weights) device pairs of ``plan`` (``_epoch_plan``'s
        rows and weights, moved to the device once)."""
        rows, weights = (torch.as_tensor(a, device=self.device) for a in plan)
        b = self.cfg.batch_size
        for start in range(0, rows.shape[0], b):
            sel = rows[start: start + b]
            yield {k: v[sel] for k, v in columns.items()}, weights[start: start + b]

    # -- public API ---------------------------------------------------------
    def fit(self, articles: Dict[str, np.ndarray]) -> List[float]:
        cfg = self.cfg
        shuffle_rng = np.random.RandomState(0)
        n = len(articles["article_id"])
        columns = self._device_columns(articles)
        epoch_losses = []
        with _full_f32():
            for epoch in range(cfg.training_epochs):
                plan = _epoch_plan(n, cfg.batch_size, shuffle_rng)
                losses = [self.train_step(batch, weights)[1]
                          for batch, weights in self._device_batches(columns, plan)]
                epoch_loss = float(np.mean(torch.stack(losses).cpu().numpy()
                                           .astype(np.float64)))
                epoch_losses.append(epoch_loss)
                log.info("ACR epoch %d: task loss %.5f", epoch, epoch_loss)
        return epoch_losses

    def _predict(self, articles: Dict[str, np.ndarray]):
        """(batch, ACE, {label: logits}, weights) of every batch of the
        articles in input order, on the device."""
        columns = self._device_columns(articles)
        plan = _epoch_plan(len(articles["article_id"]), self.cfg.batch_size)
        self.model.eval()
        with torch.no_grad(), _full_f32():
            for batch, weights in self._device_batches(columns, plan):
                if self.autoencoder:
                    ace = self.model(batch["text"], self.special_token_embedding)[0]
                    yield batch, ace, {}, weights
                    continue
                out = self.model(batch["text"])
                yield batch, out.ace, out.label_logits, weights

    def evaluate(self, articles: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Evaluate the classification heads on the train set, the
        reference's deliberate-overfit check (acr_trainer_adressa.py:368-375):
        accuracy for multiclass heads, precision/recall for multilabel
        (acr_model.py:240-268).  Counts stay on the device to the end."""
        if self.autoencoder or not self.label_specs:
            return {}
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        stats = {s.name: {"correct": zero, "total": zero, "tp": zero,
                          "pred_pos": zero, "actual_pos": zero}
                 for s in self.label_specs}
        for batch, _, logits, weight in self._predict(articles):
            valid = weight > 0
            for spec in self.label_specs:
                lg = logits[spec.name]
                st = stats[spec.name]
                if spec.classification_type == "multiclass":
                    hit = (lg.argmax(dim=1) == batch[spec.name]) & valid
                    st["correct"] = st["correct"] + hit.sum()
                    st["total"] = st["total"] + valid.sum()
                else:  # multilabel: sigmoid > 0.5 vs multi-hot of id lists
                    pred_hot = (1.0 / (1.0 + torch.exp(-lg))) > 0.5
                    true_hot = torch.zeros_like(pred_hot).scatter_(
                        1, batch[spec.name], True)
                    true_hot[:, 0] = False  # padding class never positive
                    pred_hot, true_hot = pred_hot[valid], true_hot[valid]
                    st["tp"] = st["tp"] + (pred_hot & true_hot).sum()
                    st["pred_pos"] = st["pred_pos"] + pred_hot.sum()
                    st["actual_pos"] = st["actual_pos"] + true_hot.sum()
        results: Dict[str, float] = {}
        for spec in self.label_specs:
            st = {k: int(v) for k, v in stats[spec.name].items()}
            if spec.classification_type == "multiclass":
                results[f"accuracy-{spec.name}"] = st["correct"] / max(st["total"], 1)
            else:
                results[f"precision-{spec.name}"] = st["tp"] / max(st["pred_pos"], 1)
                results[f"recall-{spec.name}"] = st["tp"] / max(st["actual_pos"], 1)
        return results

    def predict_all_ace(self, articles: Dict[str, np.ndarray]) -> np.ndarray:
        """ACE for every article row, in input order (one fetch)."""
        aces, weights = zip(*((ace, w) for _, ace, _, w in self._predict(articles)))
        keep = torch.cat(weights) > 0
        return torch.cat(aces)[keep].cpu().numpy()

    def build_ace_matrix(self, articles: Dict[str, np.ndarray]) -> np.ndarray:
        """[num_articles + 1, acr_dim] matrix indexed by article id; row 0
        (padding) = mean embedding (acr_trainer_adressa.py:264-297)."""
        ids = np.asarray(articles["article_id"])
        order = np.argsort(ids)
        sorted_ids = ids[order]
        if not np.array_equal(sorted_ids, np.arange(1, len(ids) + 1)):
            raise AssertionError(
                "article ids must be contiguous starting from 1 "
                "(reference invariant, acr_trainer_adressa.py:264-275)"
            )
        ace = self.predict_all_ace(articles)[order]
        matrix = np.zeros((len(ids) + 1, ace.shape[1]), np.float32)
        matrix[1:] = ace
        matrix[0] = ace.mean(axis=0)
        return matrix


def export_ace_pickle(path, label_encoders, articles_metadata, ace_matrix):
    """The ACR->NAR handoff artifact
    (acr_articles_metadata_embeddings.pickle, acr_trainer_adressa.py:250-254)."""
    serialize(path, (label_encoders, articles_metadata, ace_matrix))
    return path


def load_ace_for_nar(path, scale_factor: float = 1.0):
    """NAR-side load: L2-normalize rows and rescale
    (nar_trainer_gcom.py:461-474)."""
    label_encoders, metadata, ace = deserialize(path)
    norms = np.linalg.norm(ace, axis=1, keepdims=True)
    ace_normed = np.divide(ace, norms, out=np.zeros_like(ace), where=norms > 0)
    return label_encoders, metadata, ace_normed * scale_factor
