"""Sharded N-way CP/PARAFAC: mode-0 slabs with all-reduced MTTKRPs.

The port of ``tpunmf.parallel.ntf_sharded`` over ``torch.distributed``:

  * the tensor is split along mode 0 (``(axis, None, ..., None)``): each
    rank holds a contiguous slab of mode-0 rows;
  * the mode-0 factor is row-split the same way; every other factor is
    replicated (they are (dim_d, k), small beside the tensor);
  * the mode-0 MTTKRP contracts every axis but the split one, so it is
    local; the other modes' MTTKRPs contract over the slab, so each rank
    forms a partial and one all_reduce completes it;
  * the mode-0 Gram is all-reduced; the other Grams are local algebra.

An EU iteration is N-1 all-reduces of (dim_d, k) partials and one of the
(k, k) mode-0 Gram, plus the objective's Gram form, which needs nothing
more (its last MTTKRP is already global).  KL (MUR) reconstructs each mode
on the local slab only and all-reduces the local KL sums.  The replicated
factors are updated from all-reduced numerators and Grams, so every rank
holds the same bits.

MTTKRP, the reconstruction and the Hadamard of the Grams are
``solvers/ntf.py``'s; CP-HALS's component update takes ``gs_sweep`` where
the port's ``ntf`` does (float32 X, k <= 1024, ``use_pallas`` on: by
default for a CUDA mesh), its plain version elsewhere.  As in ``tpunmf``:
no ``normalize``, no checkpoint, ``obj_history`` up to the last iteration
and ``i`` one less than the iterations run.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.losses import kl_elementwise_sum
from ..core.precision import full_f32
from ..init.random import make_generator
from ..ops.hals_sweep import gs_sweep, gs_sweep_ref, sweep_takes
from ..solvers.common import host_array
from ..solvers.ntf import (NtfExperiment, NtfResults, _eu_gram_obj, _gram_except,
                           cp_reconstruct, mttkrp)
from .collectives import all_gather, all_reduce, all_reduce_in_layout, broadcast
from .mesh import axis_size, local_block, mesh_device, place
from .sharded_solvers import _loop

_EPS = 1e-9


def _check_factors(factors_init, shape, k, dtype, device):
    if len(factors_init) != len(shape):
        raise ValueError(f"factors_init must have length {len(shape)}")
    factors = []
    for d, f in enumerate(factors_init):
        f = torch.as_tensor(f, dtype=dtype).to(device)
        if tuple(f.shape) != (shape[d], k):
            raise ValueError(f"factors_init[{d}] must be {(shape[d], k)}; got {tuple(f.shape)}")
        factors.append(f.contiguous())
    if any(bool(torch.any(f < 0)) for f in factors):
        raise ValueError("factors_init must be non-negative")
    return factors


def ntf_sharded(mesh, x, k: int, *, axis: str | None = None, distance_type: str = "eu",
                update: str = "mur", min_iter: int = 10, max_iter: int = 500,
                tol1: float = 1e-5, tol2: float = 1e-5, factors_init=None, key=None,
                use_pallas=None) -> NtfResults:
    """Mesh-sharded non-negative CP factorization (mode-0 slabs).

    ``tpunmf.parallel.ntf_sharded``'s signature and checks: mode 0 must
    divide the size of ``axis`` (default: the mesh's first axis);
    ``factors_init``, when given, is the full factor list, else each mode
    is |N(0, 1)| * (mean(X)/k + 1e-9)^(1/N), drawn on rank 0 from a
    generator seeded by ``key`` (default 42) and broadcast.  Every rank
    passes the global host data and gets the same ``NtfResults``, the
    factors gathered to the host.  ``use_pallas`` (the port's own): the
    sweep kernel of CP-HALS.
    """
    shape = tuple(x.shape)
    ndim = len(shape)
    if ndim < 2:
        raise ValueError(f"x must be at least 2-way; got shape {shape}")
    axis = axis or mesh.mesh_dim_names[0]
    p = axis_size(mesh, axis)
    if shape[0] % p:
        raise ValueError(f"mesh axis size {p} must divide mode-0 dim {shape[0]}")
    if distance_type not in ("eu", "kl"):
        raise ValueError("distance_type must be 'eu' or 'kl'")
    if update not in ("mur", "hals"):
        raise ValueError("update must be 'mur' or 'hals'")
    if distance_type == "kl" and update == "hals":
        raise ValueError("HALS is least-squares only; use update='mur' for KL")
    slab = (axis,) + (None,) * (ndim - 1)
    xl = place(mesh, x, slab)
    negative = torch.any(xl < 0).to(torch.float32).reshape(1)
    if bool(all_reduce(negative, mesh, axis, dist.ReduceOp.MAX)[0]):
        raise ValueError("x must be non-negative")
    dev = mesh_device(mesh)

    with torch.no_grad(), full_f32():
        if factors_init is not None:
            factors = _check_factors(factors_init, shape, k, xl.dtype, dev)
        else:
            factors = [torch.empty((s, k), dtype=xl.dtype, device=dev) for s in shape]
            if dist.get_rank() == 0:
                # the port's ntf's draws, from the whole tensor's mean
                g = make_generator(key if key is not None else 42, dev)
                mean = torch.mean(place(mesh, x, (None,) * ndim, dtype=xl.dtype))
                scale = (mean / k + _EPS) ** (1.0 / ndim)
                for f in factors:
                    f.copy_(torch.randn(f.shape, generator=g, dtype=xl.dtype,
                                        device=g.device).abs_() * scale)
            for f in factors:
                broadcast(f)
        factors[0] = local_block(mesh, factors[0], (axis, None)).contiguous()

    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    sweep = gs_sweep if bool(use_pallas) and sweep_takes(xl, k) else gs_sweep_ref

    def psum(t):
        return all_reduce_in_layout(t, mesh, axis)

    def all_grams(fs):
        return [psum(fs[0].T @ fs[0])] + [f.T @ f for f in fs[1:]]

    def eu_step(inner, i):
        fs = list(inner)
        grams = all_grams(fs)
        m = None
        for d in range(ndim):
            m = mttkrp(xl, fs, d)
            if d > 0:
                m = psum(m)  # a partial over the slab
            g = _gram_except(grams, d)
            if update == "mur":
                fs[d] = fs[d] * (m / (fs[d] @ g + _EPS))
            else:  # one Gauss-Seidel sweep over the components
                fs[d] = sweep(m.T, g, fs[d].T, lam=0.0, nsweeps=1).T
            gd = fs[d].T @ fs[d]
            grams[d] = psum(gd) if d == 0 else gd
        # mode N-1 >= 1: its MTTKRP is already global
        return tuple(fs), _eu_gram_obj(xsq, m, fs[ndim - 1], grams)

    def kl_obj(fs):
        return psum(kl_elementwise_sum(xl, cp_reconstruct(fs)).reshape(1))[0]

    def kl_step(inner, i):
        fs = list(inner)
        for d in range(ndim):
            ratio = xl / (cp_reconstruct(fs) + _EPS)   # the local slab only
            numer = mttkrp(ratio, fs, d)
            del ratio
            if d > 0:
                numer = psum(numer)
            denom = None
            for e in range(ndim):
                if e == d:
                    continue
                s = torch.sum(fs[e], dim=0)
                if e == 0:
                    s = psum(s)
                denom = s if denom is None else denom * s
            fs[d] = fs[d] * (numer / (denom[None, :] + _EPS))
        return tuple(fs), kl_obj(fs)

    with torch.no_grad(), full_f32():
        if distance_type == "eu":
            flat = xl.reshape(-1)
            xsq = psum(torch.dot(flat, flat).reshape(1))[0]
            m_last = psum(mttkrp(xl, factors, ndim - 1))
            obj0 = _eu_gram_obj(xsq, m_last, factors[ndim - 1], all_grams(factors))
        else:
            obj0 = kl_obj(factors)
    carry = _loop(eu_step if distance_type == "eu" else kl_step, obj0.reshape(1),
                  tuple(factors), min_iter=min_iter, max_iter=max_iter, tol1=tol1, tol2=tol2)
    fs = list(carry.inner)
    fs[0] = all_gather(fs[0], mesh, axis, dim=0)
    experiment = NtfExperiment(method="ntf", components=k, distance_type=distance_type,
                               update=update, max_iter=max_iter, tol1=tol1, tol2=tol2,
                               lambdas=tuple(0.0 for _ in range(ndim)))
    completed = int(carry.i)
    obj_history = list(host_array(carry.obj_buf)[: completed + 1])
    return NtfResults(factors=[host_array(f) for f in fs], i=completed - 1,
                      obj_history=obj_history, experiment=experiment)
