"""End-to-end sharded MUR drivers over ``torch.distributed``.

The port's copy of ``tpunmf.parallel.sharded_solvers``, and the port's
form of ``tpunmf``'s GSPMD path (``NMF(data, k, mesh=m)``).

Ulysses (``mur_ulysses``, ``schedule='ulysses'``): the W update
``W *= (X H^T) / (W (H H^T))`` is row-parallel with X row-sharded and H
replicated, the H update column-parallel with X column-sharded; X is
flipped between the two layouts with one ``all_to_all`` before the loop,
and an iteration moves W (all_gather over the axis), H (all_gather) and
the objective (all_reduce).  Both halves are local, so on the card they
take the update kernels (``mur_w_update`` on the row panel,
``mur_h_update`` on the column panel) and the objective kernel on the
column panel.

Rank (``mur_rank_sharded``, ``schedule='rank'``): each rank holds a k/p
slice of the components (W (None, axis), H (axis, None)) and X
replicated; W @ H is one all_reduce of an m x n partial reconstruction,
and the factors are never gathered.  Its products are plain
``torch.matmul``.

Mesh (``mur_mesh``, the facade's ``mesh=`` without a schedule): ``mur`` on
the canonical layout, V ('rows', 'cols'), W ('rows', None), H (None,
'cols'), with the collectives GSPMD would insert written out (what
``collectives``' ``xht_psum`` and ``gram_h`` compute for the W half,
``wtx_psum`` and ``gram_w`` for the H half) and an all-reduced
objective.  A half whose contraction axis is absent or of size 1 is local
and takes its update kernel; the other takes the products, the
collectives and the canonical update (``solvers/streaming.py``), its KL
ratios on ``kl_ratio``; the plain and high-rank routes run one device's
step with ``MeshSums``.

Every driver stops on a value all ranks hold bit for bit (an all-reduced
objective), through ``solvers/common.py``'s loop: the check only at i >
min_iter, a NaN recorded but not compared.  Random and NNDSVD inits are
made once, on rank 0, and broadcast.  ``use_pallas`` picks the kernel
route (default: on for a CUDA mesh) where the kernel families'
predicates take X and k; the CPU always takes the plain versions.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core.losses import eu_elementwise_sum, eu_objective_gram, kl_elementwise_sum
from ..core.precision import full_f32
from ..core.types import MurExperiment, Results
from ..init import nndsvd as _nndsvd, random_init
from ..ops.fused import (eu_residual_obj, eu_residual_obj_ref, kl_obj, kl_obj_ref, kl_ratio,
                         kl_ratio_and_obj, kl_ratio_and_obj_ref, kl_ratio_ref, objective_takes)
from ..ops.mur_fused import mur_h_update, mur_w_update, updates_take
from ..solvers.common import (finalize_history, host_array, init_carry, verbose_precision,
                              while_block)
from ..solvers.mur import _mur_block, _passes
from ..solvers.streaming import (_kl_closed_form, _mur_h_update_eu, _mur_h_update_kl,
                                 _mur_w_update_eu, _mur_w_update_kl)
from .collectives import all_gather, all_reduce, broadcast, reshard_rows_to_cols
from .mesh import (axis_index, axis_size, has_axis, local_block, mesh_device, nmf_shardings,
                   place)

_EPS = 1e-9


def _routes(x, k: int, use_pallas):
    """(update kernels, objective kernels) for X at rank k."""
    on = x.device.type == "cuda" if use_pallas is None else bool(use_pallas)
    return on and updates_take(x, k), on and objective_takes(x, k)


def _objective_part(kl: bool, kernel: bool, x, w, h):
    """This rank's share of the objective, a 1-element tensor."""
    if kl:
        part = (kl_obj if kernel else kl_obj_ref)(x, w, h)
    else:
        part = (eu_residual_obj if kernel else eu_residual_obj_ref)(x, w, h)
    return part.reshape(1).to(w.dtype)


def _loop(step, obj0, inner, *, min_iter, max_iter, tol1, tol2):
    carry = init_carry(obj0[0], max_iter, inner)
    with torch.no_grad(), full_f32():
        carry = while_block(step, carry, max_iter, tol1, tol2, min_iter=min_iter,
                            max_iter=max_iter)
    return carry


# ---------------------------------------------------------------------------
# Ulysses-style alternating-layout MUR
# ---------------------------------------------------------------------------

def _ulysses(mesh, x_rows, w_loc, h, lambda_w, lambda_h, tol1, tol2, *, axis, min_iter,
             max_iter, distance_type, use_pallas):
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    nl = x_rows.shape[1] // p
    kl = distance_type == "kl"
    upd, obj_k = _routes(x_rows, h.shape[0], use_pallas)
    with torch.no_grad(), full_f32():
        # X is loop-invariant: the rows -> cols flip happens once
        x_cols = reshard_rows_to_cols(mesh, x_rows, axis)

    def h_block(h):
        return h[:, idx * nl:(idx + 1) * nl].contiguous()

    def objective(w_full, h_blk):
        return all_reduce(_objective_part(kl, obj_k, x_cols, w_full, h_blk), mesh, axis)

    def step(inner, i):
        w_loc, h = inner
        # W half: X row-sharded, H replicated — fully local
        if upd:
            w_loc = mur_w_update(x_rows, w_loc, h, distance_type=distance_type, lam=lambda_w)
        elif kl:
            r = x_rows / (w_loc @ h + _EPS)
            w_loc = _mur_w_update_kl(w_loc, r @ h.T, h, lambda_w)
        else:
            w_loc = _mur_w_update_eu(w_loc, x_rows @ h.T, h @ h.T, lambda_w)
        # the layout switch: W gathered for the column half
        w_full = all_gather(w_loc, mesh, axis, dim=0)
        h_blk = h_block(h)
        if upd:
            h_blk, _ = mur_h_update(x_cols, w_full, h_blk, distance_type=distance_type,
                                    lam=lambda_h)
        elif kl:
            r2 = x_cols / (w_full @ h_blk + _EPS)
            h_blk = _mur_h_update_kl(h_blk, w_full.T @ r2, w_full, lambda_h)
        else:
            h_blk = _mur_h_update_eu(h_blk, w_full.T @ x_cols, w_full.T @ w_full, lambda_h)
        h = all_gather(h_blk, mesh, axis, dim=1)
        return (w_loc, h), objective(w_full, h_blk)[0]

    with torch.no_grad(), full_f32():
        obj0 = objective(all_gather(w_loc, mesh, axis, dim=0), h_block(h))
    return _loop(step, obj0, (w_loc, h), min_iter=min_iter, max_iter=max_iter, tol1=tol1,
                 tol2=tol2)


def mur_ulysses(mesh, x, w, h, *, n_iter: int, lambda_w=0.0, lambda_h=0.0,
                axis: str | None = None, distance_type: str = "eu", use_pallas=None):
    """Run ``n_iter`` MUR iterations (EU or KL) with the alternating-layout
    (all_to_all) schedule, on this rank's blocks: x and w row-sharded
    (axis, None), h replicated.  Requires m and n divisible by the axis's
    size.  Returns (w block, h, final objective as a float)."""
    axis = axis or mesh.mesh_dim_names[0]
    p = axis_size(mesh, axis)
    m, n = x.shape[0] * p, x.shape[1]
    if n % p:
        raise ValueError(f"m={m} and n={n} must divide the mesh axis ({p})")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    # fixed-iteration mode: min_iter = max_iter, so the check never fires
    carry = _ulysses(mesh, x, w, h, float(lambda_w), float(lambda_h), 0.0, 0.0, axis=axis,
                     min_iter=int(n_iter), max_iter=int(n_iter),
                     distance_type=distance_type, use_pallas=use_pallas)
    w, h = carry.inner
    return w, h, float(carry.obj_buf[int(n_iter)])


# ---------------------------------------------------------------------------
# Rank-sharded MUR
# ---------------------------------------------------------------------------

def _rank(mesh, x, w_loc, h_loc, lambda_w, lambda_h, tol1, tol2, *, axis, min_iter,
          max_iter, distance_type):
    kl = distance_type == "kl"

    def recon(w, h):
        return all_reduce(w @ h, mesh, axis)

    def objective(wh):
        return (kl_elementwise_sum(x, wh) if kl else eu_elementwise_sum(x, wh)).reshape(1)

    def step(inner, i):
        # wh of the incoming iterate is the one the last step ended with
        w_loc, h_loc, wh = inner
        if kl:
            w_loc = _mur_w_update_kl(w_loc, (x / (wh + _EPS)) @ h_loc.T, h_loc, lambda_w)
            wh = recon(w_loc, h_loc)
            h_loc = _mur_h_update_kl(h_loc, w_loc.T @ (x / (wh + _EPS)), w_loc, lambda_h)
        else:
            # (W (H H^T))[:, slice] == (W H) H_slice^T, local given wh
            w_loc = w_loc * (x @ h_loc.T) / (wh @ h_loc.T + lambda_w * w_loc + _EPS)
            wh = recon(w_loc, h_loc)
            h_loc = h_loc * (w_loc.T @ x) / (w_loc.T @ wh + lambda_h * h_loc + _EPS)
        wh = recon(w_loc, h_loc)
        return (w_loc, h_loc, wh), objective(wh)[0]

    with torch.no_grad(), full_f32():
        wh = recon(w_loc, h_loc)
        obj0 = objective(wh)
    return _loop(step, obj0, (w_loc, h_loc, wh), min_iter=min_iter, max_iter=max_iter,
                 tol1=tol1, tol2=tol2)


def mur_rank_sharded(mesh, x, w, h, *, n_iter: int, distance_type: str = "eu",
                     lambda_w=0.0, lambda_h=0.0, axis: str = "rank"):
    """Run ``n_iter`` MUR iterations with the k axis sharded over ``axis``,
    on this rank's blocks: x replicated, w (None, axis), h (axis, None).
    Each half-step reconstructs W @ H with one all_reduce.  Returns (w
    block, h block, final objective as a float)."""
    if not has_axis(mesh, axis):
        raise ValueError(f"mesh has no '{axis}' axis")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    carry = _rank(mesh, x, w, h, float(lambda_w), float(lambda_h), 0.0, 0.0, axis=axis,
                  min_iter=int(n_iter), max_iter=int(n_iter), distance_type=distance_type)
    return carry.inner[0], carry.inner[1], float(carry.obj_buf[int(n_iter)])


# ---------------------------------------------------------------------------
# The drivers: global host data in, Results with gathered factors out
# ---------------------------------------------------------------------------

def _reduce_mesh(mesh, t, op=dist.ReduceOp.SUM):
    """``t`` reduced over every axis of the mesh."""
    for axis in mesh.mesh_dim_names:
        all_reduce(t, mesh, axis, op)
    return t


def global_inits(mesh, m, n, k, dtype, *, nndsvd_init, w_init, h_init, key,
                 kind="abs_normal", nndsvd_data=None):
    """Global (W, H) on every rank, on the mesh's device: the given inits
    (``as_input``'s rule, in ``dtype``), or made once on rank 0 (NNDSVD of
    ``nndsvd_data()``, the global X, or ``random_init``'s ``kind`` by the
    port's seeded rule) and broadcast."""
    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    if w_init is not None:
        return (place(mesh, w_init, (None, None), dtype=dtype),
                place(mesh, h_init, (None, None), dtype=dtype))
    dev = mesh_device(mesh)
    w = torch.empty((m, k), dtype=dtype, device=dev)
    h = torch.empty((k, n), dtype=dtype, device=dev)
    if dist.get_rank() == 0:
        if nndsvd_init[0]:
            xg = nndsvd_data()
            w0, h0 = _nndsvd(xg, k, variant=nndsvd_init[1], key=key)
            del xg
        else:
            w0, h0 = random_init(key, m, n, k, kind=kind, dtype=dtype, device=dev)
        w.copy_(w0)
        h.copy_(h0)
    broadcast(w)
    broadcast(h)
    return w, h


def _setup(x, k, mesh, layouts, *, nndsvd_init, w_init, h_init, key, kind="abs_normal",
           elevate=True):
    """This rank's blocks of X (elevated by the global minimum where
    ``elevate``, as MUR and HALS do), W and H under ``layouts`` (x, w, h),
    from :func:`global_inits`."""
    if (w_init is None) != (h_init is None):
        raise ValueError("pass both w_init and h_init, or neither")
    xl = place(mesh, x, layouts[0])
    shift = None
    if elevate:
        # data elevation for slightly-negative inputs (nmf/mur.py:99-102)
        low = _reduce_mesh(mesh, torch.min(xl).reshape(1), dist.ReduceOp.MIN)
        shift = torch.clamp(-low[0], min=0.0)
        xl = xl + shift

    def nndsvd_data():
        xg = place(mesh, x, (None, None))
        return xg if shift is None else xg + shift

    w, h = global_inits(mesh, *x.shape, k, xl.dtype, nndsvd_init=nndsvd_init, w_init=w_init,
                        h_init=h_init, key=key, kind=kind, nndsvd_data=nndsvd_data)
    return (xl, local_block(mesh, w, layouts[1]).contiguous(),
            local_block(mesh, h, layouts[2]).contiguous())


def _results(carry, w, h, experiment):
    i, obj_history = finalize_history(carry)
    return Results(w=host_array(w), h=host_array(h), i=i, obj_history=obj_history,
                   experiment=experiment)


def _experiment(k, distance_type, nndsvd_init, max_iter, tol1, tol2, lambda_w, lambda_h):
    return MurExperiment(method="mur", components=k, distance_type=distance_type,
                         nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1, tol2=tol2,
                         lambda_w=lambda_w, lambda_h=lambda_h)


def mur_sharded(
    x,
    k: int,
    mesh,
    *,
    schedule: str = "ulysses",
    axis: str | None = None,
    distance_type: str = "kl",
    min_iter: int = 100,
    max_iter: int = 100000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    nndsvd_init=(False, "zero"),
    w_init=None,
    h_init=None,
    key=None,
    use_pallas=None,
):
    """MUR with reference solver semantics over an explicit-collective
    schedule: ``schedule='ulysses'`` (X flipped between row- and
    column-sharded layouts by one all_to_all; the W and H panel updates
    local) or ``schedule='rank'`` (the k axis sharded; the factors never
    gathered in the loop).

    Every rank passes the global host data ``x`` (and inits) and keeps its
    block; every rank returns the same ``Results``, with the factors
    gathered to the host.  ``key``: a ``torch.Generator`` or an int seed
    for the random init (default 0).  ``use_pallas``: the update and
    objective kernels on the Ulysses halves (default: on for a CUDA mesh).
    """
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if schedule not in ("ulysses", "rank"):
        raise ValueError("schedule must be 'ulysses' or 'rank'")
    axis = axis or mesh.mesh_dim_names[0]
    p = axis_size(mesh, axis)
    m, n = x.shape
    if schedule == "ulysses" and (m % p or n % p):
        raise ValueError(f"m={m} and n={n} must divide the mesh axis ({p})")
    if schedule == "rank" and k % p:
        raise ValueError(f"rank k={k} must divide the mesh axis ({p})")
    layouts = (((axis, None), (axis, None), (None, None)) if schedule == "ulysses"
               else ((None, None), (None, axis), (axis, None)))
    xl, wl, hl = _setup(x, k, mesh, layouts, nndsvd_init=nndsvd_init, w_init=w_init,
                        h_init=h_init, key=key)
    kw = dict(axis=axis, min_iter=min_iter, max_iter=max_iter, distance_type=distance_type)
    if schedule == "ulysses":
        carry = _ulysses(mesh, xl, wl, hl, float(lambda_w), float(lambda_h), tol1, tol2,
                         use_pallas=use_pallas, **kw)
        w_loc, h = carry.inner
        w = all_gather(w_loc, mesh, axis, dim=0)
    else:
        carry = _rank(mesh, xl, wl, hl, float(lambda_w), float(lambda_h), tol1, tol2, **kw)
        w = all_gather(carry.inner[0], mesh, axis, dim=1)
        h = all_gather(carry.inner[1], mesh, axis, dim=0)
    experiment = _experiment(k, distance_type, nndsvd_init, max_iter, tol1, tol2, lambda_w,
                             lambda_h)
    return _results(carry, w, h, experiment)


def mur_mesh(
    x,
    k: int,
    mesh,
    *,
    distance_type: str = "kl",
    min_iter: int = 100,
    max_iter: int = 100000,
    tol1: float = 1e-5,
    tol2: float = 1e-5,
    lambda_w: float = 0.0,
    lambda_h: float = 0.0,
    nndsvd_init=(False, "zero"),
    save_dir: str = "./results/",
    w_init=None,
    h_init=None,
    key=None,
    objective: str = "exact",
    objective_every: int = 1,
    data_dtype=None,
    use_pallas=None,
    verbose: bool = False,
    block_size=None,
    on_block_end=None,
    checkpoint_path=None,
    checkpoint_every=None,
    resume: bool = False,
    checkpoint_backend: str = "npz",
    frame=None,
):
    """``mur`` over a mesh on the canonical layout (``nmf_shardings``): the
    facade's ``mesh=`` path, ``tpunmf``'s GSPMD run with its collectives
    written out.  Takes every keyword of ``solvers.mur``, with its
    semantics (``objective`` 'exact', 'gram' or 'lagged', ``objective_every``,
    ``data_dtype``, blocks and checkpoints), plus ``checkpoint_backend``
    ('npz' or 'dcp', ``parallel/mesh_checkpoint.py``) and ``frame``
    (``mesh_solvers._frame``).  Every rank passes the global host data and
    returns the same ``Results``; ``verbose`` prints on rank 0.

    Where the update kernels take X and k, a half whose contraction axis
    is absent or of size 1 takes its update kernel on the rank's block (the
    W pass's lagged KL too), the other its products, collectives and
    closed form (KL ratios on ``kl_ratio``, or ``kl_ratio_and_obj`` where
    'lagged' reads the incoming iterate's objective).  Elsewhere (float64,
    ``use_pallas=False``, k > 1024) it runs the one-device step of the
    high-rank or plain route (``solvers.mur._mur_block``) with
    ``MeshSums``, carrying KL's ratio as one device does; 'lagged' then
    runs as 'exact', as there."""
    from .mesh_solvers import _checkpointed, _frame, _gathered, _rank0

    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    objective_every = int(objective_every)
    if objective_every < 1:
        raise ValueError("objective_every must be >= 1")
    sums, lay = _frame(mesh, frame)
    rows, cols = lay["w"][0], lay["h"][1]
    xl = place(mesh, x, lay["v"])
    # data elevation for slightly-negative inputs (nmf/mur.py:99-102)
    low = _reduce_mesh(mesh, torch.min(xl).reshape(1), dist.ReduceOp.MIN)
    shift = torch.clamp(-low[0], min=0.0)
    xl = xl + shift
    if data_dtype is not None:
        xl = xl.to(data_dtype)
    xl = xl.contiguous()
    factor_dtype = torch.float32 if xl.dtype == torch.bfloat16 else xl.dtype

    def nndsvd_data():
        xg = place(mesh, x, (None, None)) + shift
        return (xg if data_dtype is None else xg.to(data_dtype)).to(factor_dtype)

    w, h = global_inits(mesh, *x.shape, k, factor_dtype, nndsvd_init=nndsvd_init,
                        w_init=w_init, h_init=h_init, key=key, nndsvd_data=nndsvd_data)
    w = local_block(mesh, w, lay["w"]).contiguous()
    h = local_block(mesh, h, lay["h"]).contiguous()
    kl = distance_type == "kl"
    upd, obj_k = _routes(xl, k, use_pallas)
    lam_w, lam_h = float(lambda_w), float(lambda_h)
    verbose = _rank0(verbose_precision(verbose, tol1, tol2))
    experiment = _experiment(k, distance_type, nndsvd_init, max_iter, tol1, tol2, lambda_w,
                             lambda_h)
    layouts = [lay["w"], lay["h"]]
    with torch.no_grad(), full_f32():
        if not kl and objective == "gram":
            xf = xl.to(torch.float32) if xl.dtype == torch.bfloat16 else xl
            xsq = sums.psum(torch.sum(xf * xf), "rows", "cols")
        else:
            xsq = torch.zeros((), dtype=factor_dtype, device=xl.device)
        if not upd:
            route = "high_rank" if obj_k else "plain"
            # the jnp step's products promote bf16 X; upcast it once here
            xl = xl.to(factor_dtype)
            if kl:
                r0, part = _passes(route)[1](xl, w, h, eps=_EPS)
                inner = (w, h, r0)
                layouts.append(lay["v"])
            else:
                part = _passes(route)[2](xl, w, h)
                inner = (w, h)
            obj0 = sums.psum(part, "rows", "cols")

    if not upd:
        def run(c, stop):
            return _mur_block(xl, xsq, c, stop, tol1, tol2, lam_w, lam_h,
                              distance_type=distance_type, min_iter=min_iter,
                              max_iter=max_iter, objective=objective, route=route,
                              objective_every=objective_every, verbose=verbose, sums=sums)
    else:
        # a half is local where its contraction axis is absent or of size 1
        w_local = cols is None or axis_size(mesh, cols) == 1
        h_local = rows is None or axis_size(mesh, rows) == 1
        ratio = kl_ratio if obj_k else kl_ratio_ref
        ratio_obj = kl_ratio_and_obj if obj_k else kl_ratio_and_obj_ref
        lagged = kl and objective == "lagged"

        def objective_of(w, h):
            return sums.psum(_objective_part(kl, obj_k, xl, w, h), "rows", "cols")[0]

        def step(inner, i):
            w, h = inner
            # tpunmf mur.py:96-131: a real objective every objective_every
            # iterations and at the last possible one, NaN in between
            real = objective_every == 1 or (i + 1) % objective_every == 0 or i + 1 >= max_iter
            obj = torch.tensor(math.nan)
            if w_local:
                if lagged and real:
                    w, part = mur_w_update(xl, w, h, distance_type="kl", lam=lam_w,
                                           with_lagged_obj=True)
                    obj = sums.psum(part, "rows", "cols")
                else:
                    w = mur_w_update(xl, w, h, distance_type=distance_type, lam=lam_w)
            elif kl:
                if lagged and real:
                    r, part = ratio_obj(xl, w, h, eps=_EPS)
                    obj = sums.psum(part, "rows", "cols")
                else:
                    r = ratio(xl, w, h, eps=_EPS)
                numer = sums.psum(r @ h.T, "cols")
                w = _kl_closed_form(w * numer, sums.psum(torch.sum(h, dim=1), "cols")[None, :],
                                    lam_w)
            else:
                w = _mur_w_update_eu(w, sums.psum(xl @ h.T, "cols"),
                                     sums.psum(h @ h.T, "cols"), lam_w)
            wtx = gram = None
            if h_local:
                h, wtx = mur_h_update(xl, w, h, distance_type=distance_type, lam=lam_h)
            elif kl:
                numer = sums.psum(w.T @ ratio(xl, w, h, eps=_EPS), "rows")
                h = _kl_closed_form(h * numer, sums.psum(torch.sum(w, dim=0), "rows")[:, None],
                                    lam_h)
            else:
                wtx, gram = sums.psum(w.T @ xl, "rows"), sums.psum(w.T @ w, "rows")
                h = _mur_h_update_eu(h, wtx, gram, lam_h)
            if lagged or not real:
                return (w, h), obj
            if not kl and objective == "gram":
                if gram is None:
                    gram = sums.psum(w.T @ w, "rows")
                return (w, h), eu_objective_gram(xsq, wtx, gram, h, sums)
            return (w, h), objective_of(w, h)

        with torch.no_grad(), full_f32():
            inner = (w, h)
            obj0 = objective_of(w, h)

        def run(c, stop):
            with torch.no_grad(), full_f32():
                return while_block(step, c, stop, tol1, tol2, min_iter=min_iter,
                                   max_iter=max_iter, verbose=verbose)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, inner), layouts,
                          max_iter=max_iter, config_tag=repr(experiment),
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, carry.inner[0], carry.inner[1], experiment, lay)
