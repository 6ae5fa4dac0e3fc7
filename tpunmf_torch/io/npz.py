"""Reference-compatible .npz persistence (same layout as ``tpunmf.io.npz``).

Save layout matches reference ``save_results`` (reference: nmf/utils.py:96-105):
``np.savez(save_str, w=w, h=h, i=i, obj_history=obj_history, experiment=exp)``
where ``experiment`` is the experiment-record dict.  An N-way CP
factorization (``ntf``) stores ``factor0..factorN-1`` and ``n_modes`` in
place of w/h (``tpunmf/io/npz.py``'s layout).  Files written by either
package load in the other.
"""
from __future__ import annotations

import numpy as np


def save_results(save_str: str, w, h, i, obj_history, experiment) -> str:
    """Save factorization results; returns the path written."""
    np.savez(save_str, w=np.asarray(w), h=np.asarray(h), i=i,
             obj_history=np.asarray(obj_history), experiment=experiment)
    path = save_str if str(save_str).endswith(".npz") else f"{save_str}.npz"
    print("Results saved in {}.".format(save_str))
    return path


def save_ntf_results(save_str: str, factors, i, obj_history, experiment) -> str:
    """Save an N-way CP factorization (keys ``factor0..factorN-1``, with
    ``n_modes`` and the envelope of :func:`save_results`)."""
    payload = {f"factor{d}": np.asarray(f) for d, f in enumerate(factors)}
    np.savez(save_str, i=i, obj_history=np.asarray(obj_history),
             experiment=experiment, n_modes=len(factors), **payload)
    path = save_str if str(save_str).endswith(".npz") else f"{save_str}.npz"
    print("Results saved in {}.".format(save_str))
    return path


def load_ntf_results(path: str) -> dict:
    """Load an N-way CP factorization saved by :func:`save_ntf_results`
    (or by ``tpunmf``'s)."""
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    with np.load(path, allow_pickle=True) as f:
        n = int(f["n_modes"])
        out = {
            "factors": [f[f"factor{d}"] for d in range(n)],
            "i": int(f["i"]),
            "obj_history": list(f["obj_history"]),
            "experiment": f["experiment"].item() if f["experiment"].shape == () else f["experiment"],
        }
    return out


def is_ntf_file(path: str) -> bool:
    """Whether a results file holds an N-way factorization (``n_modes``)."""
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    with np.load(path, allow_pickle=True) as f:
        return "n_modes" in f.files


def load_results(path: str) -> dict:
    """Load a results .npz (ours, tpunmf's or the reference's) into a dict."""
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    with np.load(path, allow_pickle=True) as f:
        out = {
            "w": f["w"],
            "h": f["h"],
            "i": int(f["i"]),
            "obj_history": list(f["obj_history"]),
            "experiment": f["experiment"].item() if f["experiment"].shape == () else f["experiment"],
        }
    return out
