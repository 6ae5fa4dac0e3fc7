"""Explicit-collective building blocks over ``torch.distributed``.

The port's copy of ``tpunmf.parallel.collectives``.  Each function takes
and returns this rank's local blocks, in the layout that
``nmf_shardings`` / ``rank_shardings`` name: what ``shard_map``'s body
sees in ``tpunmf``.  ``psum`` is an ``all_reduce`` over the axis's
process group, ``all_gather`` an ``all_gather``, ``all_to_all`` an
``all_to_all_single`` and ``ppermute`` a ``batch_isend_irecv`` ring step.

NMF collective structure (SURVEY §2C):
  * ``H H^T``, ``W^T X``, ``X H^T`` contract over the column-sharded item
    axis -> per-shard partial products + all_reduce over 'cols';
  * ``W^T W`` contracts over the row-sharded sample axis -> all_reduce
    over 'rows';
  * the rings rotate column panels of X / H around the mesh.

An axis the mesh lacks, or a ring or flip over one rank, takes the
one-device product, as in ``tpunmf``.  Every collective counts its calls
by kind in :data:`calls` (``all_reduce``, ``all_gather``, ``all_to_all``,
``p2p`` a ring step, ``broadcast``), as a kernel wrapper counts its
launches; :func:`reset_calls` sets them to 0.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.precision import full_f32
from .mesh import axis_group, axis_index, axis_size, has_axis

calls = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0, "p2p": 0, "broadcast": 0}


def reset_calls() -> None:
    for kind in calls:
        calls[kind] = 0


def all_reduce(t, mesh, axis: str, op=dist.ReduceOp.SUM):
    """``psum`` (or another reduction) of ``t`` over ``axis``, in place."""
    dist.all_reduce(t, op=op, group=axis_group(mesh, axis))
    calls["all_reduce"] += 1
    return t


def all_reduce_in_layout(t, mesh, axis: str):
    """:func:`all_reduce` of ``t`` keeping its layout: NCCL takes contiguous
    tensors, so a transposed ``t`` is reduced through its contiguous
    transpose (a copy only where neither is contiguous).  The sums that
    read ``t`` afterwards then run in the order they would on one device."""
    if t.is_contiguous():
        return all_reduce(t, mesh, axis)
    if t.dim() == 2 and t.T.is_contiguous():
        all_reduce(t.T, mesh, axis)
        return t
    return all_reduce(t.contiguous(), mesh, axis)


def all_gather(t, mesh, axis: str, dim: int):
    """``all_gather(tiled=True)``: the blocks of ``axis``'s ranks joined
    along ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, t, group=axis_group(mesh, axis))
    calls["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def broadcast(t, src: int = 0):
    """``t`` from global rank ``src`` to every rank, in place."""
    dist.broadcast(t, src=src)
    calls["broadcast"] += 1
    return t


def _all_to_all(send, mesh, axis: str):
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis_group(mesh, axis))
    calls["all_to_all"] += 1
    return recv


def exchange(tensors, mesh, axis: str, to: int, frm: int):
    """One ring step: send ``tensors`` to index ``to`` of ``axis`` and
    receive as many from index ``frm`` (``ppermute``)."""
    group = axis_group(mesh, axis)
    dst, src = dist.get_global_rank(group, to), dist.get_global_rank(group, frm)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, out in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    calls["p2p"] += 1
    return outs


def _axes(mesh):
    rows = "rows" if has_axis(mesh, "rows") else None
    cols = "cols" if has_axis(mesh, "cols") else None
    return rows, cols


@full_f32()
def gram_h(mesh, h):
    """H H^T with H column-sharded: local Gram + all_reduce over 'cols'."""
    _, cols = _axes(mesh)
    if cols is None:
        return h @ h.T
    return all_reduce(h @ h.T, mesh, cols)


@full_f32()
def gram_w(mesh, w):
    """W^T W with W row-sharded: local Gram + all_reduce over 'rows'."""
    rows, _ = _axes(mesh)
    if rows is None:
        return w.T @ w
    return all_reduce(w.T @ w, mesh, rows)


@full_f32()
def xht_psum(mesh, x, h):
    """X @ H^T with X ('rows', 'cols'), H (None, 'cols'): all_reduce over
    'cols', the result row-sharded like W."""
    _, cols = _axes(mesh)
    if cols is None:
        return x @ h.T
    return all_reduce(x @ h.T, mesh, cols)


@full_f32()
def wtx_psum(mesh, w, x):
    """W^T @ X with W ('rows', None), X ('rows', 'cols'): all_reduce over
    'rows', the result column-sharded like H."""
    rows, _ = _axes(mesh)
    if rows is None:
        return w.T @ x
    return all_reduce(w.T @ x, mesh, rows)


@full_f32()
def wh_psum_rank(mesh, w, h):
    """W @ H with the k axis sharded over 'rank': the partial
    reconstructions summed by all_reduce."""
    if not has_axis(mesh, "rank"):
        return w @ h
    return all_reduce(w @ h, mesh, "rank")


@full_f32()
def gram_h_rank(mesh, h):
    """H H^T with H ('rank', None): this rank's rows H_p H^T, (k/p, k),
    against the all-gathered factor."""
    if not has_axis(mesh, "rank"):
        return h @ h.T
    return h @ all_gather(h, mesh, "rank", dim=0).T


def reshard_rows_to_cols(mesh, x, axis: str = "cols"):
    """Flip x from row-sharded (axis, None) to column-sharded (None, axis)
    with one ``all_to_all``: the (m/p, n) row panel is cut into p column
    chunks and exchanged; the chunks received stack into an (m, n/p)
    column panel."""
    p = axis_size(mesh, axis)
    if p == 1:
        return x
    ml, n = x.shape
    if n % p:
        raise ValueError(f"n={n} must divide the mesh axis ({p})")
    send = x.reshape(ml, p, n // p).permute(1, 0, 2).contiguous()
    return _all_to_all(send, mesh, axis).reshape(p * ml, n // p)


def reshard_cols_to_rows(mesh, x, axis: str = "cols"):
    """Inverse of :func:`reshard_rows_to_cols`: (None, axis) -> (axis, None)."""
    p = axis_size(mesh, axis)
    if p == 1:
        return x
    m, nl = x.shape
    if m % p:
        raise ValueError(f"m={m} must divide the mesh axis ({p})")
    recv = _all_to_all(x.reshape(p, m // p, nl).contiguous(), mesh, axis)
    return recv.permute(1, 0, 2).reshape(m // p, p * nl)


@full_f32()
def ring_xht_rotate_h(mesh, x, h, axis: str = "cols"):
    """X @ H^T with X row-sharded (axis, None) and H column-sharded
    (None, axis), rotating only the small H panels around the ring: at
    step s rank d multiplies the columns of its X rows that match the
    panel it holds, (d + s) mod p, and passes the panel to d - 1.  X never
    moves; the output is row-sharded like W."""
    p = axis_size(mesh, axis)
    if p == 1:
        return x @ h.T
    nl = h.shape[1]
    idx = axis_index(mesh, axis)
    acc = torch.zeros((x.shape[0], h.shape[0]), dtype=x.dtype, device=x.device)
    hp = h
    for s in range(p):
        j = (idx + s) % p
        acc = acc + x[:, j * nl:(j + 1) * nl] @ hp.T
        if s < p - 1:
            (hp,) = exchange([hp], mesh, axis, (idx - 1) % p, (idx + 1) % p)
    return acc


@full_f32()
def ring_xht(mesh, x, h):
    """X @ H^T as a ring over 'cols': the (X panel, H panel) pair travels
    the ring (to d + 1), each rank adding the product of the pair it holds;
    after p steps every rank holds the full sum (``xht_psum``'s, its terms
    in another order)."""
    _, cols = _axes(mesh)
    if cols is None:
        return x @ h.T
    p = axis_size(mesh, cols)
    idx = axis_index(mesh, cols)
    acc = torch.zeros((x.shape[0], h.shape[0]), dtype=x.dtype, device=x.device)
    xp, hp = x, h
    for s in range(p):
        acc = acc + xp @ hp.T
        if s < p - 1:
            xp, hp = exchange([xp, hp], mesh, cols, (idx + 1) % p, (idx - 1) % p)
    return acc
