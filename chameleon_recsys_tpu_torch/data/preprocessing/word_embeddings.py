"""Word-embedding matrix assembly for the ACR vocabulary.

Twin of process_word_embedding_for_corpus_vocab
(acr_module/acr/preprocessing/word_embeddings.py:11-44): keep corpus words
present in the pretrained vectors, prepend ``<PAD>`` (row 0) and ``<UNK>``
(row 1) with U(−0.04, 0.04) vectors.  Accepts any mapping word→vector (e.g.
a loaded gensim KeyedVectors or a plain dict), keeping gensim optional.

The port's copy of
``chameleon_recsys_tpu/data/preprocessing/word_embeddings.py``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from ...config import PAD_TOKEN, UNK_TOKEN


def build_embedding_matrix_for_vocab(
    vocab_words_by_frequency: Sequence[str],
    pretrained: Mapping[str, np.ndarray],
    embedding_size: int,
    max_words: int = 50000,
    seed: int = 42,
) -> Tuple[Dict[str, int], np.ndarray]:
    rng = np.random.RandomState(seed)
    vocab: Dict[str, int] = {PAD_TOKEN: 0, UNK_TOKEN: 1}
    rows = [
        rng.uniform(-0.04, 0.04, embedding_size),  # PAD
        rng.uniform(-0.04, 0.04, embedding_size),  # UNK
    ]
    for word in vocab_words_by_frequency:
        if len(vocab) >= max_words:
            break
        if word in pretrained and word not in vocab:
            vocab[word] = len(vocab)
            rows.append(np.asarray(pretrained[word], np.float32))
    return vocab, np.vstack(rows).astype(np.float32)
