"""Solver-state checkpointing and resume, in ``tpunmf``'s file format.

The whole solver loop state (``LoopCarry``: iteration counter, objective,
convergence flag, objective trace, and the solver's factors, duals and
cached ratios) is saved atomically every block and restored into a
freshly initialized solver of the same configuration: restart after a
crash, as ``tpunmf.io.checkpoint`` does.

The ``.npz`` layout is ``tpunmf``'s: ``leaf_{i}`` for each leaf in the
order ``jax.tree_util`` flattens the same structure (tuples and named
tuples in field order, dicts by sorted key, ``None`` holds no leaf),
``n_leaves``, and a pickled ``meta`` (the solver's config tag).  A Python
``int`` is stored as int32 (``tpunmf``'s ``LoopCarry.i``), a ``bool`` as
bool, and a tensor as its numpy array on the host, in its own layout (a
transposed view as a column-major array); numpy has no bfloat16,
so a bfloat16 tensor is stored as float32 (exact) and cast back on load.
So a checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def flatten(tree) -> list:
    """Leaves of ``tree`` in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in flatten(child)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in flatten(tree[key])]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in turn from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(c, leaves) for c in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(c, leaves) for c in template)
    if isinstance(template, dict):
        return {key: _unflatten(template[key], leaves) for key in sorted(template)}
    return next(leaves)


def to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array that stores it (a tensor in its own
    layout, bfloat16 as float32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _restore(arr: np.ndarray, template):
    """``arr`` in the template leaf's kind, device and dtype.  A tensor
    keeps the layout it was saved in (``.npz`` records a column-major
    array as such): a solver that carries a factor as a transposed view
    takes the same products after a resume, so the same roundings."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(device=template.device, dtype=template.dtype)
    if isinstance(template, bool):
        return bool(arr)
    if isinstance(template, int):
        return int(arr)
    return arr.astype(np.asarray(template).dtype)


def save_state(path: str, carry, meta=None) -> str:
    """Atomically save a solver carry (nested tuples, named tuples, dicts,
    tensors, arrays and scalars) to ``path`` (``.npz`` appended where
    missing); every tensor is copied to the host."""
    leaves = flatten(carry)
    payload = {f"leaf_{i}": to_host(leaf) for i, leaf in enumerate(leaves)}
    payload["n_leaves"] = np.asarray(len(leaves))
    if meta is not None:
        payload["meta"] = np.asarray(meta, dtype=object)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        final = path if path.endswith(".npz") else path + ".npz"
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def load_state(path: str, template, expected_meta=None):
    """Restore a carry saved by :func:`save_state` (or by ``tpunmf``) into
    the structure of ``template``, a carry of the same solver
    configuration: each leaf goes back to the template leaf's device and
    dtype, and a Python ``int`` / ``bool`` leaf stays one.

    When ``expected_meta`` is given and the checkpoint stored a meta
    record, the two must match, so a checkpoint of another configuration
    is refused even where the shapes coincide; so are a different leaf
    count (another solver, or another route's state) and a different
    leaf shape."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    t_leaves = flatten(template)
    with np.load(path, allow_pickle=True) as f:
        if expected_meta is not None and "meta" in f:
            stored = f["meta"].item()
            if stored != expected_meta:
                raise ValueError(
                    "checkpoint configuration mismatch: saved by "
                    f"{stored!r}, resuming as {expected_meta!r}")
        n = int(f["n_leaves"])
        if n != len(t_leaves):
            raise ValueError(
                f"checkpoint has {n} leaves but solver state has "
                f"{len(t_leaves)} — configuration mismatch")
        leaves = []
        for i, t in enumerate(t_leaves):
            arr = f[f"leaf_{i}"]
            if arr.shape != _shape(t):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != expected "
                    f"{_shape(t)} — configuration mismatch")
            leaves.append(_restore(arr, t))
    return _unflatten(template, iter(leaves))


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path if path.endswith(".npz") else path + ".npz")
