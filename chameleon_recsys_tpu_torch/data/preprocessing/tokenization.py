"""Text tokenization and vocabulary utilities for the ACR corpus.

Re-creation of the reference's tokenization layer
(acr_module/acr/preprocessing/tokenization.py:33-58 and the language
cleaners in acr_preprocess_gcom.py:81-107 / acr_preprocess_adressa.py:302-315)
without the nltk dependency: a regex word tokenizer with the same
lowercasing + vocabulary-frequency + ``<UNK>``-fallback semantics.
Vocabulary slots 0/1 are reserved for ``<PAD>``/``<UNK>``.

The port's copy of
``chameleon_recsys_tpu/data/preprocessing/tokenization.py``.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List, Sequence

from ...config import PAD_TOKEN, UNK_TOKEN

_WORD_RE = re.compile(r"[\w']+", re.UNICODE)
_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+")


def clean_text(text: str, first_n_sentences: int = 8, max_words: int = 1000) -> str:
    """Keep the first N sentences / M words (reference truncates G1 articles
    to 8 sentences, acr_preprocess_gcom.py:81-107, and Adressa to 12
    sentences / 1000 words, acr_preprocess_adressa.py:302-315).

The port's copy of
``chameleon_recsys_tpu/data/preprocessing/tokenization.py``.
"""
    sentences = _SENTENCE_RE.split(text.strip())[:first_n_sentences]
    words = " ".join(sentences).split()[:max_words]
    return " ".join(words)


def simple_word_tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def tokenize_articles(
    texts: Iterable[str], first_n_sentences: int = 8, max_words: int = 1000
) -> List[List[str]]:
    return [
        simple_word_tokenize(clean_text(t, first_n_sentences, max_words))
        for t in texts
    ]


def build_vocabulary(
    tokenized_articles: Sequence[List[str]], max_vocab_size: int = 50000
) -> Dict[str, int]:
    """Frequency-ordered vocab with PAD=0, UNK=1
    (reference word_embeddings.py:11-44 keeps the top-N corpus words)."""
    counts = Counter(t for tokens in tokenized_articles for t in tokens)
    vocab = {PAD_TOKEN: 0, UNK_TOKEN: 1}
    for word, _ in counts.most_common(max_vocab_size - 2):
        vocab[word] = len(vocab)
    return vocab


def convert_tokens_to_int(
    tokens: List[str], vocab: Dict[str, int], max_length: int
) -> List[int]:
    """Token ids with UNK fallback, truncated/zero-padded to max_length
    (reference tokenization.py:49-58)."""
    unk = vocab[UNK_TOKEN]
    ids = [vocab.get(t, unk) for t in tokens[:max_length]]
    return ids + [0] * (max_length - len(ids))
