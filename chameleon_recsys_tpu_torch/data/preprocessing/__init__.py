"""Preprocessing helpers of the G1 and Adressa pipelines: tokenisation and
the word-embedding matrix (ACR preprocessing), the click time features,
sessionisation and the user-agent parsing (NAR preprocessing)."""
from .sessionization import sessionize_clicks
from .time_features import cycled_feature, local_time_features
from .tokenization import (
    build_vocabulary,
    convert_tokens_to_int,
    simple_word_tokenize,
)
from .word_embeddings import build_embedding_matrix_for_vocab

__all__ = [
    "build_vocabulary",
    "convert_tokens_to_int",
    "simple_word_tokenize",
    "build_embedding_matrix_for_vocab",
    "sessionize_clicks",
    "cycled_feature",
    "local_time_features",
]
