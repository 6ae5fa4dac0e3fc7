"""Data loading utilities (a copy of ``tpunmf.data.loaders``: numpy and
scipy only, returning numpy; pass the result through ``torch.from_numpy``
to run on the CPU, or straight to a solver to run on the card).

Covers the capability census of the reference's legacy CLI
(reference: nmf/nmf_old.py:28-42): .mat loading, MSOT-style 3-D stacks
flattened to 2-D in Fortran order, plus .npz/.npy/.csv — all returning a
dense non-negative float array ready for factorization.
"""
from __future__ import annotations

import os

import numpy as np


def flatten_stack(arr: np.ndarray) -> np.ndarray:
    """(x, y, frames) 3-D stack -> (x*y, frames) 2-D, Fortran order —
    the MSOT reshape from nmf/nmf_old.py:40-42."""
    if arr.ndim == 2:
        return arr
    if arr.ndim == 3:
        return arr.reshape(arr.shape[0] * arr.shape[1], arr.shape[2], order="F")
    raise ValueError(f"expected 2-D or 3-D data, got shape {arr.shape}")


def load_matrix(path: str, *, key: str | None = None,
                flatten: bool = True) -> np.ndarray:
    """Load a matrix from .npz / .npy / .mat / .csv.

    Args:
      path: file path; format inferred from extension.
      key: variable name inside .npz/.mat archives (default: the only or
        first array-valued entry).
      flatten: flatten 3-D stacks Fortran-style like the legacy CLI.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path)
    elif ext == ".npz":
        with np.load(path, allow_pickle=True) as f:
            names = [key] if key else list(f.files)
            arr = np.asarray(f[names[0]])
    elif ext == ".mat":
        from scipy import io as sio

        payload = sio.loadmat(path)
        if key is None:
            key = next(k for k in payload if not k.startswith("__"))
        arr = np.asarray(payload[key])
    elif ext in (".csv", ".txt"):
        arr = np.loadtxt(path, delimiter="," if ext == ".csv" else None)
    else:
        raise ValueError(f"unsupported data format: {ext}")

    arr = np.asarray(arr, dtype=np.float64 if arr.dtype == np.float64 else np.float32)
    return flatten_stack(arr) if flatten else arr


# ---------------------------------------------------------------------------
# Offline dataset loaders for the BASELINE configs (no network access:
# these parse the standard on-disk archive formats when present).
# ---------------------------------------------------------------------------


def load_movielens(path: str):
    """Parse a MovieLens ratings file into a sparse user x item matrix.

    Supports the three standard formats by sniffing the first line:
      * ``ratings.dat``  (ML-1M/10M):  ``user::item::rating::timestamp``
      * ``u.data``       (ML-100K):    ``user\titem\trating\ttimestamp``
      * ``ratings.csv``  (ML-20M+):    ``userId,movieId,rating,timestamp``

    Returns ``(csr_matrix, user_ids, item_ids)`` where the id arrays map
    row/column indices back to the original MovieLens ids (BASELINE
    config[2]: ML-1M user-item matrix, rank 64).
    """
    import scipy.sparse as sp

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        first = f.readline()
        if "::" in first:
            sep, skip = "::", 0
        elif "," in first and not first.rstrip("\n").split(",")[0].isdigit():
            sep, skip = ",", 1  # header row (ratings.csv)
        elif "," in first:
            sep, skip = ",", 0
        else:
            sep, skip = "\t", 0

    # compact typed buffers, not lists of boxed Python objects — ML-20M
    # has 20M rows, which would otherwise cost gigabytes transiently
    from array import array

    users = array("q")
    items = array("q")
    vals = array("f")
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for ln, line in enumerate(f):
            if ln < skip or not line.strip():
                continue
            parts = line.rstrip("\n").split(sep)
            users.append(int(parts[0]))
            items.append(int(parts[1]))
            vals.append(float(parts[2]))
    users = np.frombuffer(users, dtype=np.int64)
    items = np.frombuffer(items, dtype=np.int64)
    vals = np.frombuffer(vals, dtype=np.float32)

    user_ids, u_idx = np.unique(users, return_inverse=True)
    item_ids, i_idx = np.unique(items, return_inverse=True)
    mat = sp.coo_matrix(
        (vals, (u_idx, i_idx)),
        shape=(len(user_ids), len(item_ids)),
    ).tocsr()
    return mat, user_ids, item_ids


_TOKEN_MIN_LEN = 2


def _tokenize(text: str):
    out, cur = [], []
    for ch in text.lower():
        if ch.isalpha():
            cur.append(ch)
        elif cur:
            if len(cur) >= _TOKEN_MIN_LEN:
                out.append("".join(cur))
            cur = []
    if len(cur) >= _TOKEN_MIN_LEN:
        out.append("".join(cur))
    return out


def load_newsgroups_tfidf(root: str, *, max_features: int = 20000,
                          min_df: int = 2):
    """Build a TF-IDF term x document matrix from a 20-newsgroups-style
    directory tree (one subdirectory per group, one file per message —
    the layout of the public ``20news-bydate`` archive).

    Pure-numpy/scipy TF-IDF (no sklearn dependency): tf * log(N/df) with
    l2-normalized document columns.  Returns
    ``(csr_matrix (terms x docs), vocabulary, doc_paths)`` — the
    orientation matches BASELINE config[1] (term-doc matrix, MUR-KL).
    """
    import scipy.sparse as sp

    doc_paths = []
    for group in sorted(os.listdir(root)):
        gdir = os.path.join(root, group)
        if not os.path.isdir(gdir):
            continue
        for name in sorted(os.listdir(gdir)):
            p = os.path.join(gdir, name)
            if os.path.isfile(p):
                doc_paths.append(p)
    if not doc_paths:
        raise ValueError(f"no documents found under {root!r}")

    # pass 1: document frequencies
    df: dict[str, int] = {}
    for p in doc_paths:
        with open(p, "r", encoding="utf-8", errors="replace") as f:
            terms = set(_tokenize(f.read()))
        for t in terms:
            df[t] = df.get(t, 0) + 1
    vocab_terms = sorted(
        (t for t, c in df.items() if c >= min_df),
        key=lambda t: (-df[t], t),
    )[:max_features]
    vocab = {t: i for i, t in enumerate(vocab_terms)}

    # pass 2: tf-idf columns
    n_docs = len(doc_paths)
    rows, cols, vals = [], [], []
    for j, p in enumerate(doc_paths):
        with open(p, "r", encoding="utf-8", errors="replace") as f:
            counts: dict[int, int] = {}
            for t in _tokenize(f.read()):
                i = vocab.get(t)
                if i is not None:
                    counts[i] = counts.get(i, 0) + 1
        if not counts:
            continue
        idx = np.fromiter(counts.keys(), dtype=np.int64, count=len(counts))
        tf = np.fromiter(counts.values(), dtype=np.float32, count=len(counts))
        idf = np.log(n_docs / np.asarray([df[vocab_terms[i]] for i in idx],
                                         dtype=np.float32))
        v = tf * idf
        norm = np.sqrt(np.sum(v * v))
        if norm > 0:
            v = v / norm
        rows.extend(idx.tolist())
        cols.extend([j] * len(idx))
        vals.extend(v.tolist())

    mat = sp.coo_matrix(
        (np.asarray(vals, dtype=np.float32), (rows, cols)),
        shape=(len(vocab_terms), n_docs),
    ).tocsr()
    return mat, vocab_terms, doc_paths
