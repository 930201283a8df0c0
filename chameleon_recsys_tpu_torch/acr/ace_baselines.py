"""Unsupervised ACE baselines: LSA, W2V-TF-IDF, doc2vec (port of
``chameleon_recsys_tpu/acr/ace_baselines.py``).

Re-creation of the reference's content-embedding baselines
(acr_module/acr/preprocessing/lsa_gcom.py:141-200,
w2v_tfidf_gcom.py:203-220, doc2vec_gcom.py:211-234).  Each produces the
artifact the ACR trainer does: a [num_articles + 1, dim] float32 matrix with
the mean embedding in padding row 0, ready for the NAR handoff pickle.

LSA runs without scikit-learn, which the JAX package calls: ``tfidf`` is
``TfidfVectorizer``'s computation as ``lsa_ace`` configures it, on
``scipy.sparse``, and ``truncated_svd`` is scikit-learn 1.9's randomized
``TruncatedSVD`` (the range finder's LU power iterations, scipy's QR and
SVD, ``svd_flip`` on the rows of V) in numpy and scipy, drawing from
``np.random.RandomState(seed)`` as it does.  doc2vec is PV-DBOW in torch:
the JAX package's loss, numpy draws and Adam, on the card by default.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
from scipy import linalg

# TfidfVectorizer's default token pattern: words of two or more characters
_TOKEN = re.compile(r"(?u)\b\w\w+\b")


def _l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return np.divide(x, norms, out=np.zeros_like(x), where=norms > 0)


def _with_padding_row(embeddings: np.ndarray) -> np.ndarray:
    matrix = np.zeros((embeddings.shape[0] + 1, embeddings.shape[1]), np.float32)
    matrix[1:] = embeddings
    matrix[0] = embeddings.mean(axis=0)
    return matrix


def _ngrams(text: str, ngram_range: Tuple[int, int]) -> List[str]:
    """The analyzer: lowercase, the token pattern, then the n-grams of the
    tokens, unigrams first (``CountVectorizer._word_ngrams``)."""
    tokens = _TOKEN.findall(text.lower())
    min_n, max_n = ngram_range
    if max_n == 1:
        return tokens
    grams = list(tokens) if min_n == 1 else []
    for n in range(max(min_n, 2), min(max_n + 1, len(tokens) + 1)):
        grams += [" ".join(tokens[i: i + n]) for i in range(len(tokens) - n + 1)]
    return grams


def tfidf(texts: Sequence[str], max_features: int = 50000,
          ngram_range=(1, 3)) -> Tuple[sp.csr_array, Dict[str, int]]:
    """``TfidfVectorizer(max_features, ngram_range, sublinear_tf=True)``'s
    ``fit_transform``: counts over the analyzer's terms, the columns in
    sorted term order, the ``max_features`` terms of largest corpus count
    kept (numpy's argsort of the negated counts breaks ties, as there),
    1 + log tf, smooth idf log((1 + n) / (1 + df)) + 1, rows to unit l2
    norm.  Returns the float64 CSR matrix and the vocabulary."""
    vocabulary: Dict[str, int] = {}
    indices, indptr, values = [], [0], []
    for text in texts:
        counter: Dict[int, int] = {}
        for term in _ngrams(text, ngram_range):
            column = vocabulary.setdefault(term, len(vocabulary))
            counter[column] = counter.get(column, 0) + 1
        indices += counter.keys()
        values += counter.values()
        indptr.append(len(indices))
    x = sp.csr_array((np.asarray(values, np.intc), np.asarray(indices, np.int32),
                      np.asarray(indptr, np.int32)),
                     shape=(len(texts), len(vocabulary)), dtype=np.float64)
    x.sort_indices()
    # the columns in sorted term order
    order = np.empty(len(vocabulary), dtype=x.indices.dtype)
    for new, (term, old) in enumerate(sorted(vocabulary.items())):
        vocabulary[term] = new
        order[old] = new
    x.indices = order.take(x.indices, mode="clip")
    if max_features is not None and len(vocabulary) > max_features:
        counts = np.asarray(x.sum(axis=0)).ravel()
        keep = np.zeros(len(vocabulary), dtype=bool)
        keep[(-counts).argsort()[:max_features]] = True
        renumber = np.cumsum(keep) - 1
        vocabulary = {t: int(renumber[i]) for t, i in vocabulary.items() if keep[i]}
        x = x[:, np.where(keep)[0]]
    n_docs = x.shape[0]
    df = np.bincount(x.indices, minlength=x.shape[1]).astype(np.float64) + 1.0
    idf = np.full_like(df, fill_value=n_docs + 1, dtype=np.float64)
    idf /= df
    np.log(idf, out=idf)
    idf += 1.0
    np.log(x.data, x.data)
    x.data += 1.0
    x.data *= idf[x.indices]
    squares = x.data * x.data
    for row in range(n_docs):  # normalize(norm="l2"): each row's sum in order
        lo, hi = x.indptr[row], x.indptr[row + 1]
        if hi > lo:
            total = np.cumsum(squares[lo:hi])[-1]
            if total != 0.0:
                x.data[lo:hi] /= np.sqrt(total)
    return x, vocabulary


def _svd_flip_rows(u: np.ndarray, v: np.ndarray):
    """``svd_flip(u, v, u_based_decision=False)``: each row of v's largest
    absolute entry made positive, u's columns alike."""
    signs = np.sign(v[np.arange(v.shape[0]), np.argmax(np.abs(v), axis=1)])
    u *= signs[np.newaxis, :]
    v *= signs[:, np.newaxis]
    return u, v


def truncated_svd(x, n_components: int, seed: int, n_iter: int = 5,
                  n_oversamples: int = 10) -> np.ndarray:
    """``TruncatedSVD(n_components, random_state=seed).fit_transform(x)``
    (algorithm "randomized", power iteration normaliser "auto", which is LU
    at 5 iterations), scikit-learn 1.9's code path in numpy and scipy."""
    random_state = np.random.RandomState(seed)
    m = x.T if x.shape[0] < x.shape[1] else x  # the narrower side on the right
    transpose = m is not x
    q = random_state.normal(size=(m.shape[1], n_components + n_oversamples))
    for _ in range(n_iter):
        q, _ = linalg.lu(m @ q, permute_l=True, check_finite=False)
        q, _ = linalg.lu(m.T @ q, permute_l=True, check_finite=False)
    q, _ = linalg.qr(m @ q, mode="economic", check_finite=False)
    u_hat, s, vt = linalg.svd(q.T @ m, full_matrices=False, lapack_driver="gesdd")
    u = q @ u_hat
    if transpose:
        u, vt = vt[:n_components].T, u[:, :n_components].T
    else:
        u, vt = u[:, :n_components], vt[:n_components]
    u, vt = _svd_flip_rows(u, vt)
    return np.asarray(x @ vt.T)


def lsa_ace(
    texts: Sequence[str],
    dim: int = 250,
    max_features: int = 50000,
    ngram_range=(1, 3),
    seed: int = 42,
) -> np.ndarray:
    """TF-IDF (1-3 grams) -> truncated SVD -> L2 norm
    (reference lsa_gcom.py:141-200)."""
    x, _ = tfidf(texts, max_features=max_features, ngram_range=ngram_range)
    reduced = truncated_svd(x, min(dim, x.shape[1] - 1), seed)
    if reduced.shape[1] < dim:  # tiny corpora: pad to the requested dim
        reduced = np.pad(reduced, ((0, 0), (0, dim - reduced.shape[1])))
    return _with_padding_row(_l2_normalize_rows(reduced).astype(np.float32))


def w2v_tfidf_ace(
    token_ids: np.ndarray,  # [N, L] int token matrix, 0 = padding
    word_embeddings: np.ndarray,  # [vocab, D]
) -> np.ndarray:
    """TF-IDF-weighted average of word vectors
    (reference w2v_tfidf_gcom.py:203-220), over the token matrix."""
    n, _ = token_ids.shape
    vocab = word_embeddings.shape[0]
    df = np.zeros(vocab, np.float64)  # document frequency per token id
    for i in range(n):
        df[np.unique(token_ids[i][token_ids[i] != 0])] += 1.0
    idf = np.log((1.0 + n) / (1.0 + df)) + 1.0

    docs = np.zeros((n, word_embeddings.shape[1]), np.float64)
    for i in range(n):
        toks = token_ids[i][token_ids[i] != 0]
        if len(toks) == 0:
            continue
        # one tf-idf weight per distinct word (as TfidfVectorizer): weighting
        # every occurrence would count repeated words quadratically
        uniq, counts = np.unique(toks, return_counts=True)
        weights = counts.astype(np.float64) / len(toks) * idf[uniq]
        weights /= max(weights.sum(), 1e-12)
        docs[i] = weights @ word_embeddings[uniq]
    return _with_padding_row(_l2_normalize_rows(docs).astype(np.float32))


def doc2vec_ace(
    token_ids: np.ndarray,  # [N, L]
    vocab_size: int,
    dim: int = 250,
    epochs: int = 30,
    n_negative: int = 64,
    learning_rate: float = 1e-2,
    batch_size: int = 256,
    seed: int = 42,
    device="cuda",
    _init=None,
) -> np.ndarray:
    """PV-DBOW document embeddings (replaces the reference's gensim Doc2Vec,
    doc2vec_gcom.py:211-234; vec 250, 30 epochs): each document vector
    predicts its words against sampled negatives, softplus losses, Adam.
    The batches and negatives are the JAX package's numpy draws from
    ``RandomState(seed)``; the initial N(0, 0.01^2) matrices come from a
    torch generator seeded with ``seed`` (``_init``, a (doc, word) pair of
    arrays, replaces them)."""
    import torch
    import torch.nn.functional as F

    n, _ = token_ids.shape
    if _init is None:
        g = torch.Generator().manual_seed(seed)
        init = (torch.randn(n, dim, generator=g) * 0.01,
                torch.randn(vocab_size, dim, generator=g) * 0.01)
    else:
        init = tuple(torch.as_tensor(np.asarray(a, np.float32)) for a in _init)
    doc, word = (t.to(device).requires_grad_() for t in init)
    # optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)
    optimizer = torch.optim.Adam([doc, word], lr=learning_rate, eps=1e-8)
    tokens = torch.as_tensor(np.asarray(token_ids), device=device).long()

    np_rng = np.random.RandomState(seed)
    nonzero_tokens = token_ids[token_ids != 0]
    if len(nonzero_tokens) == 0:
        nonzero_tokens = np.array([1])
    for _ in range(epochs):
        order = np_rng.permutation(n)
        for start in range(0, n, batch_size):
            idx = order[start: start + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, idx[: batch_size - len(idx)]])
            neg = np_rng.choice(nonzero_tokens, size=n_negative)
            idx_t = torch.as_tensor(idx, device=device)
            neg_t = torch.as_tensor(neg, device=device).long()
            docs = doc[idx_t]  # [B, dim]
            words = tokens[idx_t]  # [B, L]
            mask = (words != 0).float()
            pos_scores = torch.einsum("bd,bld->bl", docs, word[words])
            neg_scores = docs @ word[neg_t].T
            pos_loss = (F.softplus(-pos_scores) * mask).sum() / mask.sum().clamp(min=1.0)
            loss = pos_loss + F.softplus(neg_scores).mean()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()

    docs = doc.detach().cpu().numpy()
    return _with_padding_row(_l2_normalize_rows(docs).astype(np.float32))
