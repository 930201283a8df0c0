"""Feature schemas, the NAR configuration and the run configuration.

A copy of the NAR and ACR parts of ``chameleon_recsys_tpu/config.py``, of
its ``RunConfig``, of its feature-group ablation toggles (G1 and Adressa)
and of the G1 schemas, with the same names, so a configuration written for
the JAX package carries over field by field (the Adressa schemas live in
``cli/nar_preprocess_adressa.py``, as in the JAX package).
``use_pallas_rnn`` and ``use_pallas_scorer``
keep their names: in this package they route the session RNN and the pooled
path's negatives through the hand-written CUDA kernels
(``ops/kernels/ugrnn.py``, ``ops/kernels/cand_scorer.py``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

# Timestamps in memory are int32 seconds since a per-dataset epoch; on disk
# they are unix milliseconds (ingest divides by TIME_UNIT_MS).
TIME_UNIT_MS = 1000
SECONDS_PER_DAY = 60 * 60 * 24
SECONDS_PER_HOUR = 60 * 60

PAD_TOKEN = "<PAD>"
UNK_TOKEN = "<UNK>"


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

    def by_name(self, name: str) -> FeatureSpec:
        for f in self.single + self.sequence:
            if f.name == name:
                return f
        raise KeyError(name)


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
    loss.
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


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: data-parallel over sessions, model-parallel
    (row-sharded) over embedding tables (``parallel/mesh.py``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallelism: int = 1
    model_parallelism: int = 1


@dataclass(frozen=True)
class RunConfig:
    """Temporal train/eval protocol (reference nar_trainer_gcom.py:505-525)."""

    model_dir: str = "/tmp/chameleon_tpu"
    training_hours_for_each_eval: int = 5
    train_files_from: int = 0
    train_files_up_to: int = 0  # 0 = all
    save_results_each_n_evals: int = 1
    checkpoint_every_n_hours: int = 10
    random_seed: int = 42
    enable_profiler: bool = False


@dataclass(frozen=True)
class ACRConfig:
    """ACR module hyperparameters (reference README.md:114-141,
    acr_trainer_adressa.py:23-57)."""

    training_task: str = "metadata_classification"  # | 'autoencoder'
    text_feature_extractor: str = "CNN"  # 'CNN' | 'GRU' | 'LSTM'
    word_embedding_size: int = 300
    vocab_size: int = 50000
    truncate_tokens_length: int = 300
    acr_embeddings_size: int = 250
    cnn_filter_sizes: Tuple[int, ...] = (3, 4, 5)
    cnn_num_filters: int = 128
    rnn_units: int = 250
    rnn_layers: int = 1
    rnn_direction: str = "unidirectional"  # | 'bidirectional'
    learning_rate: float = 3e-4
    dropout_keep_prob: float = 1.0
    l2_reg_lambda: float = 7e-4
    autoencoder_noise: float = 0.0
    batch_size: int = 64
    training_epochs: int = 1
    compute_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Feature-group ablation toggles (the paper's Input-Configuration axes,
# reference nar_trainer_gcom.py:109-231): a disabled group's features leave
# the schema, which drives both parsing and the feature towers
# ---------------------------------------------------------------------------

ALL_FEATURES = "ALL"
NO_FEATURES = "NONE"

GCOM_SESSION_FEATURE_GROUPS = {
    "time": ["local_hour_sin", "local_hour_cos", "local_weekday"],
    "device": ["environment", "deviceGroup", "os"],
    "location": ["country", "region"],
    "referrer": ["referrer_type"],
}

GCOM_ARTICLE_FEATURE_GROUPS = {
    "category": ["category_id"],
}

ADRESSA_SESSION_FEATURE_GROUPS = {
    "time": ["local_hour_sin", "local_hour_cos", "weekday"],
    "device": ["device", "os"],
    "location": ["city", "region", "country"],
    "referrer": ["referrer_class"],
    "engagement": ["active_time_secs"],
}

ADRESSA_ARTICLE_FEATURE_GROUPS = {
    "category": ["category0", "category1"],
    "author": ["author"],
}


@dataclass(frozen=True)
class ExperimentConfig:
    nar: NARConfig = NARConfig()
    acr: ACRConfig = ACRConfig()
    run: RunConfig = RunConfig()
    mesh: MeshConfig = MeshConfig()
    session_schema: SessionFeaturesSchema = SessionFeaturesSchema()
    article_schema: ArticleFeaturesSchema = ArticleFeaturesSchema()


def replace(cfg, **kwargs):
    """dataclasses.replace passthrough for ergonomic config overrides."""
    return dataclasses.replace(cfg, **kwargs)


def _parse_groups(enabled) -> Optional[set]:
    """'ALL'/['ALL'] -> None (keep everything); 'NONE'/['NONE'] -> empty set;
    csv string or list of names -> set of group names."""
    if enabled is None:
        return None
    if isinstance(enabled, str):
        names = [x.strip() for x in enabled.split(",") if x.strip()]
    else:
        names = [str(x).strip() for x in enabled]
    if ALL_FEATURES in names:
        return None
    if names == [NO_FEATURES] or not names:
        return set()
    return set(names)


def _group_drop_set(enabled_groups, groups_map, protected) -> Optional[set]:
    """Features of disabled groups, never touching ``protected`` names.
    Unknown group names are an error: a misspelled ablation flag would
    attribute results to the wrong input configuration."""
    enabled = _parse_groups(enabled_groups)
    if enabled is None:
        return None
    unknown = enabled - set(groups_map)
    if unknown:
        raise ValueError(
            f"unknown feature groups {sorted(unknown)}; "
            f"valid: {sorted(groups_map)} (or ALL/NONE)"
        )
    drop = {
        f
        for group, feats in groups_map.items()
        if group not in enabled
        for f in feats
    }
    return drop - set(protected)


def filter_session_schema(
    schema: SessionFeaturesSchema, enabled_groups, groups_map=None
) -> SessionFeaturesSchema:
    """Drop the sequence features of disabled groups (structural features,
    item_clicked/event_timestamp and anything ungrouped, always stay)."""
    drop = _group_drop_set(
        enabled_groups,
        groups_map or GCOM_SESSION_FEATURE_GROUPS,
        SESSION_REQ_SEQ_FEATURES,
    )
    if drop is None:
        return schema
    return SessionFeaturesSchema(
        single=schema.single,
        sequence=tuple(f for f in schema.sequence if f.name not in drop),
    )


def filter_article_schema(
    schema: ArticleFeaturesSchema, enabled_groups, groups_map=None
) -> ArticleFeaturesSchema:
    drop = _group_drop_set(
        enabled_groups,
        groups_map or GCOM_ARTICLE_FEATURE_GROUPS,
        ARTICLE_REQ_FEATURES,
    )
    if drop is None:
        return schema
    return ArticleFeaturesSchema(
        features=tuple(f for f in schema.features if f.name not in drop)
    )


# ---------------------------------------------------------------------------
# Reference dataset schemas
# ---------------------------------------------------------------------------

def gcom_article_schema(num_items: int = 364047,
                        num_categories: int = 461) -> ArticleFeaturesSchema:
    """G1/Globo.com article metadata schema (nar_trainer_gcom.py:99-128)."""
    return ArticleFeaturesSchema(
        features=(
            FeatureSpec("article_id", "categorical", num_items),
            FeatureSpec("created_at_ts", "numerical", dtype="int"),
            FeatureSpec("category_id", "categorical", num_categories),
        )
    )


def gcom_session_schema(
    num_items: int = 364047, num_users: int = 341193
) -> SessionFeaturesSchema:
    """G1/Globo.com session schema (nar_trainer_gcom.py:150-218)."""
    return SessionFeaturesSchema(
        single=(
            FeatureSpec("user_id", "categorical", num_users),
            FeatureSpec("session_id", "numerical", dtype="int"),
            FeatureSpec("session_start", "numerical", dtype="int"),
            FeatureSpec("session_size", "numerical", dtype="int"),
        ),
        sequence=(
            FeatureSpec("event_timestamp", "numerical", dtype="int"),
            FeatureSpec("item_clicked", "categorical", num_items),
            FeatureSpec("environment", "categorical", 5),
            FeatureSpec("deviceGroup", "categorical", 6),
            FeatureSpec("os", "categorical", 23),
            FeatureSpec("country", "categorical", 12),
            FeatureSpec("region", "categorical", 29),
            FeatureSpec("local_hour_sin", "numerical", dtype="float"),
            FeatureSpec("local_hour_cos", "numerical", dtype="float"),
            FeatureSpec("local_weekday", "numerical", dtype="float"),
            FeatureSpec("referrer_type", "categorical", 8),
        ),
    )
