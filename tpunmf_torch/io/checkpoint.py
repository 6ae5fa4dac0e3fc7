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

The second backend, :func:`save_state_dcp` / :func:`load_state_dcp` /
:func:`checkpoint_exists_dcp`, stands for ``tpunmf``'s orbax trio on
``torch.distributed.checkpoint`` (DCP): a directory ``path + '.dcp'``
whose leaves are ``leaf_{i}``, and beside them ``tpunmf_meta.json``
(``n_leaves``, ``meta``, and which leaves were column-major), written by
rank 0 after the save has finished, so that its presence certifies a
whole checkpoint.  Over a mesh, each leaf that the mesh splits is saved
as a ``DTensor`` of the rank's block with ``Shard`` placements, so the
directory holds the global arrays: it loads onto another mesh shape, or
onto one process with no group.
"""
from __future__ import annotations

import json
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


# ---------------------------------------------------------------------------
# The DCP backend: tpunmf's orbax trio (tpunmf/io/checkpoint.py:92-152)
# ---------------------------------------------------------------------------

_META = "tpunmf_meta.json"


def _dcp_dir(path: str) -> str:
    return os.path.abspath(path if path.endswith(".dcp") else path + ".dcp")


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _dcp_call(fn, state, d):
    """``dcp.save`` / ``dcp.load`` over the default group, or in this
    process alone where there is none (DCP warns that it assumes so)."""
    import warnings

    if _group_up():
        return fn(state, checkpoint_id=d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(state, checkpoint_id=d, no_dist=True)


def _barrier() -> None:
    if _group_up():
        import torch.distributed as dist

        dist.barrier()


def _writer() -> bool:
    if not _group_up():
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def _col_major(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.dim() == 2 and not t.is_contiguous()
            and t.T.is_contiguous())


def _placements(mesh, layout):
    """DTensor placements of a block cut by ``layout`` (a tuple, one mesh
    axis a dimension, or None), or None where the mesh splits no
    dimension."""
    from torch.distributed.tensor import Replicate, Shard

    if mesh is None or layout is None:
        return None
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    split = False
    for dim, axis in enumerate(layout):
        if axis is not None and axis in names:
            out[names.index(axis)] = Shard(dim)
            split = True
    return out if split else None


def _layouts_of(template, layouts):
    n = len(flatten(template))
    if layouts is None:
        return [None] * n
    if len(layouts) != n:
        raise ValueError(f"{len(layouts)} layouts for {n} leaves")
    return list(layouts)


def save_state_dcp(path: str, carry, meta=None, *, mesh=None, layouts=None) -> str:
    """Save a solver carry through ``torch.distributed.checkpoint`` (the
    directory ``path + '.dcp'``).  With ``mesh`` and ``layouts`` (one entry
    a leaf, in :func:`flatten`'s order: a tuple of axis names, one a
    dimension, or None for a leaf every rank holds whole), every rank calls this with
    its blocks and the directory holds the global arrays; without them the
    carry is saved whole.  Works with and without a process group."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    leaves = flatten(carry)
    kinds = _layouts_of(carry, layouts)
    d = _dcp_dir(path)
    if _writer():
        os.makedirs(d, exist_ok=True)
        # the meta file certifies a whole checkpoint: it goes first, then
        # the last save's files
        for name in [_META] + sorted(set(os.listdir(d)) - {_META}):
            if os.path.isfile(os.path.join(d, name)):
                os.unlink(os.path.join(d, name))
    _barrier()
    state = {}
    for i, (leaf, layout) in enumerate(zip(leaves, kinds)):
        place = _placements(mesh, layout) if isinstance(leaf, torch.Tensor) else None
        if place is not None:
            state[f"leaf_{i}"] = DTensor.from_local(leaf.detach().contiguous(), mesh, place,
                                                    run_check=False)
        elif isinstance(leaf, torch.Tensor):
            state[f"leaf_{i}"] = leaf.detach().contiguous()
        else:
            state[f"leaf_{i}"] = torch.from_numpy(to_host(leaf))
    _dcp_call(dcp.save, state, d)
    _barrier()
    if _writer():
        tmp = os.path.join(d, "." + _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"n_leaves": len(leaves), "meta": meta,
                       "col_major": [i for i, t in enumerate(leaves) if _col_major(t)]}, f)
        os.replace(tmp, os.path.join(d, _META))
    _barrier()
    return d


def load_state_dcp(path: str, template, expected_meta=None, *, mesh=None, layouts=None):
    """Restore a carry saved by :func:`save_state_dcp` into the structure of
    ``template`` (same checks as :func:`load_state`: the meta record, the
    leaf count, each leaf's global shape).  With ``mesh`` and ``layouts``,
    ``template`` holds this rank's blocks and each rank reads its own
    block, whatever the mesh the checkpoint was saved from; without them
    the global arrays.  A leaf saved column-major comes back so."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    d = _dcp_dir(path)
    with open(os.path.join(d, _META)) as f:
        info = json.load(f)
    if expected_meta is not None and info.get("meta") is not None:
        if info["meta"] != expected_meta:
            raise ValueError(
                "checkpoint configuration mismatch: saved by "
                f"{info['meta']!r}, resuming as {expected_meta!r}")
    t_leaves = flatten(template)
    if info["n_leaves"] != len(t_leaves):
        raise ValueError(
            f"checkpoint has {info['n_leaves']} leaves but solver state has "
            f"{len(t_leaves)} — configuration mismatch")
    stored = dcp.FileSystemReader(d).read_metadata().state_dict_metadata
    kinds = _layouts_of(template, layouts)
    state, places = {}, []
    for i, (t, layout) in enumerate(zip(t_leaves, kinds)):
        entry = stored[f"leaf_{i}"]
        place = _placements(mesh, layout) if isinstance(t, torch.Tensor) else None
        local = tuple(t.shape) if isinstance(t, torch.Tensor) else np.shape(t)
        want = local if place is None else _global_shape(mesh, layout, local)
        if tuple(entry.size) != tuple(want):
            raise ValueError(
                f"checkpoint leaf {i} shape {tuple(entry.size)} != expected "
                f"{tuple(want)} — configuration mismatch")
        dtype = entry.properties.dtype
        if place is not None:
            block = torch.empty(local, dtype=dtype, device=t.device)
            state[f"leaf_{i}"] = DTensor.from_local(block, mesh, place, run_check=False)
        else:
            dev = t.device if isinstance(t, torch.Tensor) else "cpu"
            state[f"leaf_{i}"] = torch.empty(want, dtype=dtype, device=dev)
        places.append(place)
    _dcp_call(dcp.load, state, d)
    col_major = set(info.get("col_major", ()))
    leaves = []
    for i, (t, place) in enumerate(zip(t_leaves, places)):
        got = state[f"leaf_{i}"]
        if isinstance(got, DTensor):
            got = got.to_local()
        if isinstance(t, torch.Tensor):
            got = got.to(device=t.device, dtype=t.dtype)
            if i in col_major and got.dim() == 2:
                got = got.T.contiguous().T
            leaves.append(got)
        else:
            leaves.append(_restore(got.cpu().numpy(), t))
    return _unflatten(template, iter(leaves))


def _global_shape(mesh, layout, local):
    names = list(mesh.mesh_dim_names)
    return tuple(s * (int(mesh.size(names.index(a))) if a is not None and a in names else 1)
                 for s, a in zip(local, layout))


def checkpoint_exists_dcp(path: str) -> bool:
    # the meta file is written (atomically) only after the save finished,
    # so its presence certifies a whole, loadable checkpoint
    return os.path.exists(os.path.join(_dcp_dir(path), _META))
