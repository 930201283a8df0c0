"""The port's unsupervised ACE baselines against the JAX package's, on the
CPU, on a small two-topic corpus from a numpy seed.

* TF-IDF: the port's ``tfidf`` (no scikit-learn) against
  ``TfidfVectorizer(max_features, ngram_range=(1, 3), sublinear_tf=True)``,
  the JAX package's settings, within 1e-12, the vocabulary and its column
  order equal, with and without the ``max_features`` cut;
* LSA: the port's ``lsa_ace`` against the JAX ``lsa_ace`` (scikit-learn's
  ``TruncatedSVD``) within 1e-5, at a rank under the vocabulary and at one
  past it (zero-padded);
* W2V-TF-IDF within 1e-6;
* doc2vec (PV-DBOW) from the JAX function's initial matrices over 2 epochs
  within 1e-5 (Adam in both; the numpy batches and negatives are shared).
"""
import jax
import numpy as np
import pytest
from sklearn.feature_extraction.text import TfidfVectorizer

from chameleon_recsys_tpu.acr import ace_baselines as jax_ace

from chameleon_recsys_tpu_torch.acr import ace_baselines


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(0)
    vocab_size, n, length = 100, 30, 15
    token_ids = np.zeros((n, length), np.int32)
    for i in range(n):
        lo = 10 + (i % 2) * 40
        filled = rng.randint(6, length + 1)
        token_ids[i, :filled] = rng.randint(lo, lo + 25, filled)
    texts = [" ".join(f"Tok{t}" for t in row[row != 0]) + ", a. B c!" for row in token_ids]
    word_emb = rng.randn(vocab_size, 16).astype(np.float32)
    return token_ids, texts, word_emb, vocab_size


@pytest.mark.parametrize("max_features", [50000, 60])
def test_tfidf_matches_sklearn(corpus, max_features):
    _, texts, _, _ = corpus
    vectorizer = TfidfVectorizer(max_features=max_features, ngram_range=(1, 3),
                                 sublinear_tf=True)
    want = vectorizer.fit_transform(texts)
    got, vocabulary = ace_baselines.tfidf(texts, max_features=max_features)
    assert vocabulary == vectorizer.vocabulary_
    assert got.shape == want.shape and (max_features == 50000 or got.shape[1] == 60)
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dim", [8, 2000])
def test_lsa_matches_jax(corpus, dim):
    _, texts, _, _ = corpus
    want = jax_ace.lsa_ace(texts, dim=dim)
    got = ace_baselines.lsa_ace(texts, dim=dim)
    assert got.shape == want.shape == (len(texts) + 1, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], got[1:].mean(axis=0), atol=1e-6)


def test_w2v_tfidf_matches_jax(corpus):
    token_ids, _, word_emb, _ = corpus
    want = jax_ace.w2v_tfidf_ace(token_ids, word_emb)
    got = ace_baselines.w2v_tfidf_ace(token_ids, word_emb)
    assert got.shape == (len(token_ids) + 1, word_emb.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_doc2vec_matches_jax(corpus):
    token_ids, _, _, vocab_size = corpus
    kwargs = dict(dim=16, epochs=2, n_negative=16, learning_rate=5e-2, batch_size=8,
                  seed=7)
    want = jax_ace.doc2vec_ace(token_ids, vocab_size, **kwargs)
    # the JAX function's initial matrices (its first three draws)
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(7), 3)
    init = (np.asarray(jax.random.normal(k1, (len(token_ids), 16)) * 0.01),
            np.asarray(jax.random.normal(k2, (vocab_size, 16)) * 0.01))
    got = ace_baselines.doc2vec_ace(token_ids, vocab_size, device="cpu", _init=init,
                                    **kwargs)
    assert got.shape == (len(token_ids) + 1, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the port's own initial draw gives another, equally shaped answer
    own = ace_baselines.doc2vec_ace(token_ids, vocab_size, device="cpu", **kwargs)
    assert own.shape == got.shape and np.isfinite(own).all()
