"""Synthetic data generators (numpy and scipy), the same as ``tpunmf.data``'s.

Copies of ``lowrank_dense``, ``tfidf_like``, ``movielens_like`` and
``sparse_csr`` from tpunmf/data/synthetic.py, so that the port's scripts
make the same matrices from the same seeds without importing ``tpunmf``
(which imports JAX).
"""
from __future__ import annotations

import os

import numpy as np


def lowrank_dense(m: int, n: int, k: int, *, noise: float = 0.01, seed: int = 0,
                  dtype=np.float32) -> np.ndarray:
    """Dense non-negative matrix with planted rank-k structure
    (BASELINE config[0]: 2000x1000, rank 20)."""
    rng = np.random.default_rng(seed)
    w = rng.random((m, k))
    h = rng.random((k, n))
    x = w @ h + noise * rng.random((m, n))
    return x.astype(dtype)


def tfidf_like(n_terms: int, n_docs: int, *, n_topics: int = 50,
               doc_len: int = 200, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Sparse non-negative term-document matrix with topic structure and
    Zipfian term marginals (BASELINE config[1] stand-in for 20-newsgroups)."""
    rng = np.random.default_rng(seed)
    # topic-term distributions: Zipf-weighted sparse rows
    base = 1.0 / np.arange(1, n_terms + 1)
    topic_term = np.stack(
        [rng.permutation(base) * rng.random(n_terms) for _ in range(n_topics)]
    )
    topic_term /= topic_term.sum(axis=1, keepdims=True)
    # documents: mixture of 1-3 topics, multinomial term counts
    counts = np.zeros((n_terms, n_docs))
    for j in range(n_docs):
        t = rng.choice(n_topics, size=rng.integers(1, 4), replace=False)
        mix = topic_term[t].mean(axis=0)
        counts[:, j] = rng.multinomial(doc_len, mix)
    # tf-idf transform
    tf = counts / np.maximum(counts.sum(axis=0, keepdims=True), 1)
    df = (counts > 0).sum(axis=1)
    idf = np.log((1 + n_docs) / (1 + df)) + 1.0
    return (tf * idf[:, None]).astype(dtype)


def movielens_like(n_users: int, n_items: int, *, n_factors: int = 8,
                   density: float = 0.05, seed: int = 0,
                   dtype=np.float32) -> np.ndarray:
    """Dense-ified recommender matrix: planted user/item factors, ratings
    1..5 on a random support, zeros elsewhere (BASELINE config[2] stand-in
    for MovieLens-1M)."""
    rng = np.random.default_rng(seed)
    u = rng.gamma(2.0, 1.0, (n_users, n_factors))
    v = rng.gamma(2.0, 1.0, (n_factors, n_items))
    scores = u @ v
    scores = 1 + 4 * (scores - scores.min()) / (np.ptp(scores) + 1e-9)
    mask = rng.random((n_users, n_items)) < density
    return (np.round(scores) * mask).astype(dtype)


# entries per chunk of sparse_csr's values (2**14 x k f64 products each)
_SPARSE_CHUNK = 1 << 14


def sparse_csr(m: int, n: int, *, density: float = 0.01, k: int = 16,
               seed: int = 0, dtype=np.float32):
    """Sparse non-negative matrix in scipy CSR with planted structure
    (BASELINE configs[3,4] families).

    The same draws as ``tpunmf``'s, and the same matrix bit for bit: each
    entry's value is the same row-wise sum of the same k products (a
    C-ordered (entries, k) array, as ``w[rows] * h[:, cols].T`` is),
    computed here in chunks of entries on a few threads, so that BASELINE
    config[3] (2e7 entries at k = 128) neither holds 20 GB of products at
    once nor takes a minute."""
    import scipy.sparse as sp
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    nnz = int(m * n * density)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    w = rng.random((m, k))
    h = rng.random((k, n))
    ht = np.ascontiguousarray(h.T)
    vals = np.empty(nnz, dtype=dtype)

    def chunk(s):
        e = s + _SPARSE_CHUNK
        vals[s:e] = (w[rows[s:e]] * ht[cols[s:e]]).sum(axis=1)

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(chunk, range(0, nnz, _SPARSE_CHUNK)))
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    return mat

