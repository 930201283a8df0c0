"""Feature schemas and the NAR configuration.

A copy of the NAR part of ``chameleon_recsys_tpu/config.py`` with the same
class and field names, so a configuration written for the JAX package
carries over field by field.  ``use_pallas_rnn`` and ``use_pallas_scorer``
keep their names: in this package they route the session RNN and the pooled
path's negatives through the hand-written CUDA kernels
(``ops/kernels/ugrnn.py``, ``ops/kernels/cand_scorer.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

SECONDS_PER_DAY = 60 * 60 * 24
SECONDS_PER_HOUR = 60 * 60


def embedding_dim_for_cardinality(cardinality: int, const_mult: int = 8) -> int:
    """Embedding size heuristic ``floor(8 * cardinality**0.25)``."""
    return int(math.floor(const_mult * cardinality ** 0.25))


@dataclass(frozen=True)
class FeatureSpec:
    """One input feature."""

    name: str
    kind: str  # 'categorical' | 'numerical'
    cardinality: int = 0  # only for categorical
    dtype: str = "int"  # 'int' | 'float'

    def __post_init__(self):
        if self.kind not in ("categorical", "numerical"):
            raise ValueError(f"invalid feature kind: {self.kind}")
        if self.kind == "categorical" and self.cardinality <= 0:
            raise ValueError(f"categorical feature {self.name} needs cardinality")


# Features the NAR model consumes structurally, never as context towers.
SESSION_REQ_SEQ_FEATURES = ("event_timestamp", "item_clicked")
ARTICLE_REQ_FEATURES = ("article_id", "created_at_ts")


@dataclass(frozen=True)
class SessionFeaturesSchema:
    """Schema of the session stream."""

    single: Tuple[FeatureSpec, ...] = ()
    sequence: Tuple[FeatureSpec, ...] = ()

    def context_sequence_features(self) -> Tuple[FeatureSpec, ...]:
        return tuple(
            f for f in self.sequence if f.name not in SESSION_REQ_SEQ_FEATURES
        )


@dataclass(frozen=True)
class ArticleFeaturesSchema:
    """Schema of per-article metadata."""

    features: Tuple[FeatureSpec, ...] = ()

    @property
    def num_items(self) -> int:
        return self.by_name("article_id").cardinality

    def metadata_features(self) -> Tuple[FeatureSpec, ...]:
        return tuple(f for f in self.features if f.name not in ARTICLE_REQ_FEATURES)

    def by_name(self, name: str) -> FeatureSpec:
        for f in self.features:
            if f.name == name:
                return f
        raise KeyError(name)


@dataclass(frozen=True)
class InternalFeaturesConfig:
    """Toggles for model-internal item features."""

    recency: bool = True
    novelty: bool = True
    article_content_embeddings: bool = True
    item_clicked_embeddings: bool = True


@dataclass(frozen=True)
class NARConfig:
    """NAR model + streaming-state hyperparameters (G1 defaults).

    Fields the ported paths do not read (``approx_negative_topk``,
    ``rng_impl``) are kept so that every JAX configuration converts without
    loss; ``train_compaction_groups > 1`` raises in the train step.
    """

    # architecture
    car_embedding_size: int = 1024
    rnn_units: int = 255
    rnn_num_layers: int = 2
    matching_layer_sizes: Tuple[int, ...] = (128, 64, 32)
    max_cardinality_for_ohe: int = 10
    item_embedding_const_mult: int = 8

    # training
    learning_rate: float = 1e-4
    keep_prob: float = 1.0
    reg_weight_decay: float = 1e-5
    softmax_temperature: float = 0.1
    novelty_reg_factor: float = 0.0

    # negative sampling (train)
    negative_samples: int = 50
    negative_sample_from_buffer: int = 3000
    neg_sampling_multiplying_factor: int = 20

    # negative sampling (eval)
    eval_negative_samples: int = 50
    eval_negative_sample_from_buffer: int = 5000

    # streaming state
    recent_clicks_buffer_hours: float = 1.0
    recent_clicks_buffer_max_size: int = 20000
    recent_clicks_for_normalization: int = 5000

    # dynamic feature smoothing
    elapsed_days_smooth_log_base: float = 1.3
    popularity_smooth_log_base: float = 2.0

    # data shapes
    batch_size: int = 256
    max_session_length: int = 20  # truncate_session_length

    # eval
    metrics_top_n: int = 10
    eval_negative_sample_relevance: float = 0.02

    internal_features: InternalFeaturesConfig = InternalFeaturesConfig()

    # numerics: parameters are always f32; activations may run in bfloat16
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    # kernels: route the session RNN through the hand-written UGRNN kernel
    use_pallas_rnn: bool = False
    # pooled path: route the negatives through the hand-written fused scorer
    # kernels (ops/kernels/cand_scorer.py) at three matching layers
    use_pallas_scorer: bool = False
    # TPU-only approximate top-k in the JAX sampler; this port's sampler is
    # always exact (ops/sampling.py)
    approx_negative_topk: bool = False
    train_valid_row_capacity: Optional[int] = None
    train_compaction_groups: int = 1
    rng_impl: str = "threefry2x32"

    @property
    def max_inputs_length(self) -> int:
        """T = session length minus the final click (label-only)."""
        return self.max_session_length - 1
