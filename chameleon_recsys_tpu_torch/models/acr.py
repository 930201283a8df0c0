"""ACR, the Article Content Representation models: the metadata
classifier and the GRU denoising autoencoder (port of
``chameleon_recsys_tpu/models/acr.py``).

``ACRClassifierModel``, twin of the reference ``ACR_Model``
(acr_module/acr/acr_model.py:103-268): a text encoder (a CNN over the word
embeddings with max-pool over time, or a GRU or LSTM stack over the reversed
token sequence with max-pool over its outputs) -> dropout -> Dense(relu) ->
Dense(tanh) = the Article Content Embedding (ACE) -> dropout -> one softmax
or sigmoid head per label, with class weights.

``ACRAutoencoderModel`` (acr_model.py:403-531): Gaussian noise on the word
embeddings in training -> a GRU encoder over the reversed sequence (its
direction the config's) -> a tanh bottleneck of each layer's final state,
the last layer's being the ACE -> each decoder layer's initial state
re-expanded from it -> a unidirectional GRU decoder over the special token
and the sequence shifted right -> a projection back to the word
embeddings, with the masked squared error as the loss.

Dropout (``ops/dropout.py``) acts in training only, with masks drawn from
the ``generator`` passed to ``forward``: between RNN layers, then (the
classifier) on the content and on the ACE before the heads.  The word
embeddings are frozen: a buffer, not a parameter, so neither Adam nor the
L2 term of ``acr/trainer.py`` touches them.  Parameters are initialised
from the distributions of the JAX package's Flax init (lecun normal
kernels, zero biases; the ACE layer glorot uniform; the RNN layers as
``ops/rnn.py`` says).  ``convert.acr_params_from_flax`` loads a Flax tree.

``ACRConfig.compute_dtype`` "bfloat16" mirrors the JAX models' Flax
``dtype=bf16`` with ``param_dtype=f32``: the parameters stay float32 and
are cast to bf16 at each use; the embedding lookup's rows, the convs (the
bias added after the product, as Flax does), the RNN stacks and every Dense
layer compute in bf16, and so do the activations and the dropout between
them; the noise is cast to bf16 before it is scaled and added; the logits,
the reconstruction, the ACE the models return and every loss are float32,
cast exactly where the JAX models cast them.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ACRConfig
from ..ops.dropout import dropout
from ..ops.rnn import StackedGRU, StackedLSTM


class ACRLabelSpec(NamedTuple):
    name: str
    cardinality: int
    classification_type: str  # 'multiclass' | 'multilabel'
    feature_weight_on_loss: float = 1.0


class ACROutputs(NamedTuple):
    ace: torch.Tensor  # [B, acr_dim] article content embedding
    label_logits: Dict[str, torch.Tensor]
    loss: torch.Tensor
    per_label_loss: Dict[str, torch.Tensor]


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """Flax's default kernel init: a normal truncated at two deviations,
    scaled so that its variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def glorot_uniform_(weight: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
    fan_out, fan_in = weight.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    weight.uniform_(-limit, limit, generator=generator)


def compute_dtype(cfg: ACRConfig) -> torch.dtype:
    """``cfg.compute_dtype`` as a torch dtype (float32 or bfloat16)."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.compute_dtype not in dtypes:
        raise ValueError(f"invalid ACR compute_dtype {cfg.compute_dtype!r}")
    return dtypes[cfg.compute_dtype]


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax's ``Dense(dtype=...)``: in float32 the layer itself; in bf16 the
    input and the f32 parameters cast, the product, then the bias."""
    if dtype == torch.float32:
        return layer(x)
    return x.to(dtype) @ layer.weight.to(dtype).T + layer.bias.to(dtype)


class TextCNN(nn.Module):
    """Multi-width conv1d bank with max-pool over time
    (reference cnn_feature_extractor, acr_model.py:272-289): per width a
    VALID conv, ReLU and the max over time, concatenated."""

    def __init__(self, in_features: int, filter_sizes, num_filters: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleDict({
            f"conv_{width}": nn.Conv1d(in_features, num_filters, width)
            for width in filter_sizes
        })

    @property
    def out_features(self) -> int:
        return sum(conv.out_channels for conv in self.convs.values())

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for conv in self.convs.values():
                out_channels, in_channels, width = conv.weight.shape
                lecun_normal_(conv.weight, in_channels * width, generator)
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, D]
        dt = self.dtype
        xt = x.transpose(1, 2)
        if dt == torch.float32:
            convs = [conv(xt) for conv in self.convs.values()]
        else:
            xt = xt.to(dt)
            convs = [F.conv1d(xt, conv.weight.to(dt)) + conv.bias.to(dt)[:, None]
                     for conv in self.convs.values()]
        return torch.cat([F.relu(c).amax(dim=2) for c in convs], dim=-1)


class ACRClassifierModel(nn.Module):
    """The metadata-classification ACR model (acr_model.py:103-268)."""

    def __init__(self, cfg: ACRConfig, label_specs, word_embeddings):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.label_specs = tuple(label_specs)
        embeddings = torch.as_tensor(np.asarray(word_embeddings, np.float32))
        self.register_buffer("word_embeddings", embeddings)
        extractor = cfg.text_feature_extractor.upper()
        if extractor == "CNN":
            self.encoder = TextCNN(embeddings.shape[1], cfg.cnn_filter_sizes,
                                   cfg.cnn_num_filters, dtype=self.dtype)
        elif extractor in ("GRU", "LSTM"):
            stack = StackedLSTM if extractor == "LSTM" else StackedGRU
            self.encoder = stack(embeddings.shape[1], cfg.rnn_units, cfg.rnn_layers,
                                 keep_prob=cfg.dropout_keep_prob,
                                 direction=cfg.rnn_direction, dtype=self.dtype)
        else:
            raise ValueError(
                f"invalid text_feature_extractor {cfg.text_feature_extractor}")
        self.extractor = extractor
        self.fc2 = nn.Linear(self.encoder.out_features, cfg.acr_embeddings_size)
        self.article_content_embedding = nn.Linear(cfg.acr_embeddings_size,
                                                   cfg.acr_embeddings_size)
        self.outputs = nn.ModuleDict({
            spec.name: nn.Linear(cfg.acr_embeddings_size, spec.cardinality)
            for spec in self.label_specs
        })

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.encoder.reset_parameters(generator)
        with torch.no_grad():
            for layer in (self.fc2, *self.outputs.values()):
                lecun_normal_(layer.weight, layer.in_features, generator)
                layer.bias.zero_()
            glorot_uniform_(self.article_content_embedding.weight, generator)
            self.article_content_embedding.bias.zero_()

    def forward(
        self,
        text_tokens: torch.Tensor,  # [B, L] int
        labels: Optional[Dict[str, torch.Tensor]] = None,
        label_class_weights: Optional[Dict[str, torch.Tensor]] = None,
        example_weights: Optional[torch.Tensor] = None,  # [B] 0 = padded row
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> ACROutputs:
        keep = self.cfg.dropout_keep_prob if train else 1.0
        dt = self.dtype
        emb = self.word_embeddings[text_tokens].to(dt)  # [B, L, D]
        if self.extractor == "CNN":
            content = self.encoder(emb)
        else:
            # reversed input: the most relevant words lead the document
            # (acr_model.py:116-117); every step valid, as cuDNN ignores
            # lengths (:397); max-pool over the outputs (:124)
            out, _ = self.encoder(emb.flip(1), train=train, generator=generator)
            content = out.amax(dim=1)
        content = dropout(content, keep, generator)
        fc2 = F.relu(_dense(self.fc2, content, dt))
        ace = torch.tanh(_dense(self.article_content_embedding, fc2, dt))

        hidden = dropout(ace, keep, generator)
        label_logits, per_label_loss = {}, {}
        total_loss = torch.zeros((), device=ace.device)
        for spec in self.label_specs:
            logits = _dense(self.outputs[spec.name], hidden, dt).float()
            label_logits[spec.name] = logits
            if labels is None:
                continue
            y = labels[spec.name]
            ew = (logits.new_ones(y.shape[0]) if example_weights is None
                  else example_weights.float())
            if spec.classification_type == "multiclass":
                xe = -F.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]
                if label_class_weights and spec.name in label_class_weights:
                    w = label_class_weights[spec.name][y] * ew
                else:
                    w = ew
                # tf.losses.sparse_softmax_cross_entropy's default reduction,
                # SUM_BY_NONZERO_WEIGHTS (acr_model.py:196-198): the weighted
                # sum over the count of nonzero weights, not over their sum
                n_present = (w != 0).float().sum()
                loss = (xe * w).sum() / n_present.clamp(min=1.0)
            elif spec.classification_type == "multilabel":
                # y: [B, num_ids] padded id lists -> multi-hot with the
                # padding class zeroed (acr_model.py:202-210)
                multi_hot = torch.zeros_like(logits).scatter_(1, y, 1.0)
                multi_hot[:, 0] = 0.0
                per_example = optax_sigmoid_xe(logits, multi_hot).mean(dim=1)
                loss = (per_example * ew).sum() / ew.sum().clamp(min=1e-9)
            else:
                raise ValueError(spec.classification_type)
            per_label_loss[spec.name] = loss
            total_loss = total_loss + spec.feature_weight_on_loss * loss
        return ACROutputs(ace, label_logits, total_loss, per_label_loss)


def optax_sigmoid_xe(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy (tf.nn.sigmoid_cross_entropy
    semantics)."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _draw_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal noise of ``shape``: the autoencoder's draw, which
    tests replace (``monkeypatch``) to inject another implementation's."""
    return torch.randn(shape, generator=generator, device=device)


class ACRAutoencoderModel(nn.Module):
    """GRU sequence-denoising autoencoder (acr_model.py:403-531)."""

    def __init__(self, cfg: ACRConfig, word_embeddings):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        embeddings = torch.as_tensor(np.asarray(word_embeddings, np.float32))
        self.register_buffer("word_embeddings", embeddings)
        word_dim = embeddings.shape[1]
        # the encoder honours rnn_direction (the reference routes both RNNs
        # through build_cudnn_rnn, acr_model.py:428, 462); the decoder stays
        # unidirectional: its layers are seeded from the bottleneck's states
        self.encoder = StackedGRU(word_dim, cfg.rnn_units, cfg.rnn_layers,
                                  keep_prob=cfg.dropout_keep_prob,
                                  direction=cfg.rnn_direction, dtype=dt)
        self.bottleneck = nn.Linear(self.encoder.out_features, cfg.acr_embeddings_size)
        self.state_reconstruction = nn.Linear(cfg.acr_embeddings_size, cfg.rnn_units)
        self.decoder = StackedGRU(word_dim, cfg.rnn_units, cfg.rnn_layers,
                                  keep_prob=cfg.dropout_keep_prob, dtype=dt)
        self.output_projection = nn.Linear(cfg.rnn_units, word_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.encoder.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        with torch.no_grad():
            for layer in (self.bottleneck, self.state_reconstruction,
                          self.output_projection):
                lecun_normal_(layer.weight, layer.in_features, generator)
                layer.bias.zero_()

    def forward(
        self,
        text_tokens: torch.Tensor,  # [B, L] int
        special_token_embedding: torch.Tensor,  # [1, word_dim]
        example_weights: Optional[torch.Tensor] = None,  # [B] 0 = padded row
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """-> (ACE [B, acr_dim], reconstruction [B, L, word_dim], loss).  In
        training the noise is drawn first, then the encoder's and the
        decoder's dropout masks, all from ``generator``."""
        cfg, dt = self.cfg, self.dtype
        emb = self.word_embeddings[text_tokens].to(dt)  # [B, L, D]
        b, _, d = emb.shape
        # denoising noise only while training (the reference injects it in
        # every mode, acr_model.py:414-417; the JAX package gates it on train)
        noisy = emb
        if cfg.autoencoder_noise > 0.0 and train:
            noise = _draw_noise(emb.shape, generator, emb.device).to(dt)
            noisy = emb + cfg.autoencoder_noise * noise
        _, enc_finals = self.encoder(noisy.flip(1), train=train, generator=generator)
        # [layers, B, acr]
        compressed = torch.tanh(_dense(self.bottleneck, enc_finals, dt))
        ace = compressed[-1]  # the last layer's state (acr_model.py:452)
        # [layers, B, U]
        reexpanded = torch.tanh(_dense(self.state_reconstruction, compressed, dt))
        special = special_token_embedding.to(emb)[None].expand(b, 1, d)
        decoder_input = torch.cat([special, emb[:, :-1]], dim=1)
        dec_out, _ = self.decoder(decoder_input, reexpanded, train=train,
                                  generator=generator)
        reconstructed = _dense(self.output_projection, dec_out, dt).float()

        mask = (text_tokens != 0).float()[..., None]
        if example_weights is not None:
            mask = mask * example_weights.float()[:, None, None]
        mask = mask.expand(emb.shape)
        target = emb.float()
        sq_err = (target * mask - reconstructed * mask).square()
        loss = sq_err.sum() / mask.sum().clamp(min=1.0)
        return ace.float(), reconstructed, loss
