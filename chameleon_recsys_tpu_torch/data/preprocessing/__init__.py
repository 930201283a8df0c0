"""Preprocessing helpers of the G1 pipeline: the click time features
(``time_features.py``), the one module of
``chameleon_recsys_tpu/data/preprocessing/`` that ``cli/nar_preprocess_gcom.py``
needs.  Tokenisation, word embeddings and sessionisation come with the ACR
and Adressa slices."""
from .time_features import cycled_feature, local_time_features

__all__ = ["cycled_feature", "local_time_features"]
