"""The reference solvers over a mesh: the facade's ``mesh=`` for HALS, ANLS,
ADMM, AO-ADMM and masked MUR.

``tpunmf`` runs every solver under ``NMF(..., mesh=)`` on sharded data and
lets GSPMD partition it.  Here, as ``mur_mesh`` does for MUR, the
collectives GSPMD would insert are written out, on the canonical layout
(``nmf_shardings``): V ('rows', 'cols'), W ('rows', None), H (None,
'cols').  Each driver keeps the one-device solver's own step
(``hals._hals_block``, ``anls._anls_block``, ``admm._admm_block``,
``ao_admm._ao_admm_block``) and runs it on this rank's blocks with
:class:`MeshSums` in place of the one-device identity
(``core/sums.py``): every product whose contraction runs over a split axis
is this rank's partial, summed by an all_reduce over that axis (W^T W and
W^T V over 'rows', H H^T and V H^T over 'cols': what ``collectives``'
``gram_w``, ``wtx_psum``, ``gram_h`` and ``xht_psum`` compute, each
formed as the one-device step writes it), every objective and every
norm of a split factor over the axes that split it.
The k x k solves are replicated, from identical all-reduced inputs; the
NNLS, the sweeps and the elementwise passes (ADMM's KL split among them)
work on the rank's own blocks.  The row-wise l1,inf prox, which sorts
along a split axis, takes the whole rows (an all_gather of a k x n
factor) and keeps the rank's columns.

Every loop that runs a collective decides on all-reduced values, so
every rank takes the same trips: the outer loop on the objective,
AO-ADMM's inner loops on norms of the whole factor (a trip's norms in one
all_reduce), ADMM's adaptive rho on all-reduced residuals.  ANLS's NNLS
loops may take other trips on each rank, because nothing inside them
communicates.

Masked MUR: a half whose contraction axis is absent or of size 1 takes
its masked update kernel on the local block, as ``mur_mesh`` does; the
other forms the update's two products on its block (``masked_fused``'s
``masked_w_parts`` / ``masked_h_parts``), sums them over the axis and
applies the plain version's closed form.  The mask is cut by X's layout
and goes through ``as_input``'s rule.

Every rank passes the global host data and gets the same ``Results``,
the factors gathered to the host.  Inits are the given ones, or made on
rank 0 and broadcast.  The solvers' checkpoint and blocked-execution
keywords are not ported over a mesh and raise.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core.losses import distance
from ..core.precision import full_f32
from ..core.sums import Sums
from ..core.types import AdmmExperiment, AnlsExperiment, AoAdmmExperiment, MurExperiment
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref, objective_takes
from ..ops.hals_sweep import sweep_takes
from ..ops.masked_fused import (masked_h_closed, masked_h_parts, masked_h_update, masked_takes,
                                masked_w_closed, masked_w_parts, masked_w_update)
from ..solvers import cuda_defaults
from ..solvers.admm import _admm_block
from ..solvers.anls import _anls_block
from ..solvers.ao_admm import _ao_admm_block
from ..solvers.common import init_carry, verbose_precision, while_block
from ..solvers.hals import _EPS as _HALS_EPS, _hals_block
from ..solvers.masked import _masked_eu_obj, _masked_kl_obj
from .collectives import all_gather, all_reduce_in_layout
from .mesh import axis_index, axis_size, has_axis, local_block, nmf_shardings, place
from .sharded_solvers import _reduce_mesh, _results, _setup, global_inits


class MeshSums(Sums):
    """``core/sums.py``'s hooks over a mesh: a partial sum all-reduced
    over the axes of the roles it names ('rows', 'cols' of the step's
    frame; an axis the mesh lacks is whole already).  An axis the mesh has
    is reduced whatever its size, as ``collectives`` does."""

    def __init__(self, mesh, rows: str = "rows", cols: str = "cols"):
        self.mesh = mesh
        self.axes = {"rows": rows, "cols": cols}

    def _present(self, over):
        return [a for a in (self.axes[o] for o in over) if has_axis(self.mesh, a)]

    def psum(self, t, *over):
        axes = self._present(over)
        if t.dim() == 0:
            return self.psum(t.reshape(1), *over)[0] if axes else t
        for axis in axes:
            t = all_reduce_in_layout(t, self.mesh, axis)
        return t

    def norms(self, ts, *over):
        if not self._present(over):
            return tuple(torch.linalg.vector_norm(t) for t in ts)
        squares = self.psum(torch.stack([torch.sum(t * t) for t in ts]), *over)
        return tuple(torch.sqrt(squares).unbind())

    def numel(self, t, *over) -> int:
        return t.numel() * math.prod(axis_size(self.mesh, a) for a in self._present(over))

    def whole(self, fn, over: str, *arrays):
        axes = self._present((over,))
        if not axes:
            return fn(*arrays)
        axis = axes[0]
        out = fn(*(all_gather(a, self.mesh, axis, dim=1) for a in arrays))
        cols = out.shape[1] // axis_size(self.mesh, axis)
        start = axis_index(self.mesh, axis) * cols
        return out[:, start:start + cols]

    @property
    def T(self) -> "MeshSums":
        return MeshSums(self.mesh, rows=self.axes["cols"], cols=self.axes["rows"])


def _refuse(unported, method: str):
    if unported:
        raise NotImplementedError(
            f"{', '.join(sorted(unported))}: {method} over mesh= does not take these yet "
            "(ROADMAP.md, queue 1, item 9)")


def _canonical(mesh):
    sh = nmf_shardings(mesh)
    return (sh["v"], sh["w"], sh["h"]), sh["w"][0], sh["h"][1]


def _gathered(mesh, carry, w, h, experiment):
    """The same ``Results`` on every rank: W gathered over 'rows', H over
    'cols'."""
    _, rows, cols = _canonical(mesh)
    if rows is not None:
        w = all_gather(w, mesh, rows, dim=0)
    if cols is not None:
        h = all_gather(h, mesh, cols, dim=1)
    return _results(carry, w, h, experiment)


def _local_half(mesh, axis) -> bool:
    """Whether a half whose contraction runs over ``axis`` is local."""
    return axis is None or axis_size(mesh, axis) == 1


def hals_mesh(x, k: int, mesh, *, distance_type: str = "eu", min_iter: int = 20,
              max_iter: int = 1000, tol1: float = 1e-5, tol2: float = 1e-5,
              lambda_w: float = 0.0, lambda_h: float = 0.0, nndsvd_init=(True, "zero"),
              inner_sweeps: int = 2, sweep_unroll: int = 8, w_init=None, h_init=None,
              key=None, objective: str = "exact", use_pallas=None, verbose: bool = False,
              **unported):
    """``solvers.hals`` over a mesh: the W half's sweeps (``gs_sweep`` where
    the kernel takes X and k) on the rank's rows from X H^T (over 'cols')
    and H H^T, the H half's on its columns from W^T X and W^T W (over
    'rows'); the exact objective's partials (``eu_residual_obj``) over
    both axes, or the Gram form from an all-reduced ||X||^2.  The single
    pass (``hals_iteration_eu``) stays one-device."""
    _refuse(unported, "hals")
    if distance_type != "eu":
        raise KeyError("HALS is Euclidean-only; use mur/admm for 'kl'.")
    if inner_sweeps < 1:
        raise ValueError("inner_sweeps must be >= 1")
    layouts, _, _ = _canonical(mesh)
    xl, w, h = _setup(x, k, mesh, layouts, nndsvd_init=nndsvd_init, w_init=w_init,
                      h_init=h_init, key=key)
    if w_init is None:
        # HALS divides by Gram diagonals: no component may start frozen
        w, h = torch.clamp(w, min=_HALS_EPS), torch.clamp(h, min=_HALS_EPS)
    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    sweep_kernel = bool(use_pallas) and sweep_takes(xl, k)
    objective_kernel = (bool(use_pallas) and xl.dtype == torch.float32
                        and objective_takes(xl, k))
    sums = MeshSums(mesh)
    experiment = MurExperiment(method="hals", components=k, distance_type="eu",
                               nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1,
                               tol2=tol2, lambda_w=lambda_w, lambda_h=lambda_h)
    with torch.no_grad(), full_f32():
        if objective == "gram":
            xf = xl.to(torch.float32) if xl.dtype == torch.bfloat16 else xl
            xsq = sums.psum(torch.sum(xf * xf), "rows", "cols")
        else:
            xsq = torch.zeros((), dtype=xl.dtype, device=xl.device)
        residual = eu_residual_obj if objective_kernel else eu_residual_obj_ref
        obj0 = sums.psum(residual(xl, w, h), "rows", "cols")
    carry = _hals_block(xl, xsq, init_carry(obj0, max_iter, (w, h)), max_iter, tol1, tol2,
                        float(lambda_w), float(lambda_h), min_iter=min_iter,
                        max_iter=max_iter, inner_sweeps=inner_sweeps, objective=objective,
                        sweep_kernel=sweep_kernel, objective_kernel=objective_kernel,
                        verbose=verbose, sums=sums)
    return _gathered(mesh, carry, *carry.inner, experiment)


def anls_mesh(x, k: int, mesh, *, distance_type: str = "eu", use_fcnnls: bool = False,
              lambda_w: float = 0.0, lambda_h: float = 0.0, min_iter: int = 10,
              max_iter: int = 1000, tol1: float = 1e-3, tol2: float = 1e-3,
              nndsvd_init=(True, "zero"), save_dir: str = "./results/",
              nnls_solver: str = "activeset", masked_solver=None, nnls_opts=None,
              w_init=None, h_init=None, key=None, use_pallas=None, device_loop=None,
              verbose: bool = False, **unported):
    """``solvers.anls`` over a mesh: H's columns solved on each rank from
    W^T W and its columns of W^T X (over 'rows'), W's rows from H H^T and
    its rows of H X^T (over 'cols'); the NNLS ('activeset' or 'bpp', with
    its warm start) on the rank's own columns; the objective's partials
    (``eu_residual_obj`` / ``kl_obj``) over both axes."""
    _refuse(unported, "anls")
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if nnls_solver not in ("activeset", "bpp"):
        raise ValueError("nnls_solver must be 'activeset' or 'bpp'")
    if masked_solver not in (None, "chol", "cg"):
        raise ValueError("masked_solver must be 'chol' or 'cg'")
    nnls_opts = dict(nnls_opts or {})
    if nnls_opts and nnls_solver == "bpp":
        raise ValueError(
            "nnls_opts applies to the active-set solver only; it would be "
            "silently ignored with nnls_solver='bpp'")
    layouts, _, _ = _canonical(mesh)
    # ANLS does not elevate X; its random init is U[0, 1) (nmf/anls.py:104-105)
    xl, w, h = _setup(x, k, mesh, layouts, nndsvd_init=nndsvd_init, w_init=w_init,
                      h_init=h_init, key=key, kind="uniform", elevate=False)
    if xl.dtype == torch.bfloat16:
        raise NotImplementedError(
            "Unsupported dtype bfloat16: ANLS's batched Cholesky takes float32 or "
            "float64 X, as in tpunmf")
    if masked_solver is None:
        masked_solver = cuda_defaults.anls_masked_solver(xl.device)
    if nnls_solver == "activeset" and masked_solver == "cg":
        nnls_opts.setdefault("cg_iters", cuda_defaults.anls_cg_iters(xl.device))
        nnls_opts.setdefault("precision", None)
    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    kernels = bool(use_pallas) and xl.dtype == torch.float32 and objective_takes(xl, k)
    sums = MeshSums(mesh)
    experiment = AnlsExperiment(method="anls", components=k, distance_type=distance_type,
                                nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1,
                                tol2=tol2, lambda_w=lambda_w, lambda_h=lambda_h,
                                fcnnls=use_fcnnls)
    with torch.no_grad(), full_f32():
        obj0 = sums.psum(distance(xl, w @ h, distance_type), "rows", "cols")
    carry = _anls_block(xl, init_carry(obj0, max_iter, (w, h)), max_iter, tol1, tol2,
                        lambda_w, lambda_h, k=k, distance_type=distance_type,
                        nnls_solver=nnls_solver, solve_method=masked_solver,
                        nnls_opts=nnls_opts, min_iter=min_iter, max_iter=max_iter,
                        use_pallas=kernels, verbose=verbose_precision(verbose, tol1, tol2),
                        sums=sums)
    return _gathered(mesh, carry, *carry.inner, experiment)


def admm_mesh(v, k: int, mesh, *, rho: float = 1.0, distance_type: str = "eu",
              reg_w=(0, "nn"), reg_h=(0, "l2n"), min_iter: int = 10,
              max_iter: int = 100000, tol1: float = 1e-3, tol2: float = 1e-3,
              nndsvd_init=(True, "zero"), save_dir: str = "./results/",
              rho_mode: str = "fixed", rho_tau: float = 2.0, rho_mu: float = 10.0,
              spd_solver=None, w_init=None, h_init=None, key=None, use_pallas=None,
              verbose: bool = False, **unported):
    """``solvers.admm`` over a mesh: W_aux^T V and the k x k Grams over
    'rows' (H's side), H_aux V^T over 'cols' (W's side), the Cholesky
    solves replicated, V_aux, dual_V and the KL split on the rank's block,
    the objective (``eu_residual_obj`` / ``kl_ratio_and_obj``) and the
    adaptive rho's residual sums all-reduced."""
    _refuse(unported, "admm")
    if distance_type not in ("eu", "kl"):
        raise TypeError("Unknown loss type.")
    if rho_mode not in ("fixed", "adaptive"):
        raise ValueError("rho_mode must be 'fixed' or 'adaptive'")
    spd_solver = "chol" if spd_solver is None else spd_solver
    if spd_solver not in ("chol", "cg"):
        raise ValueError("spd_solver must be 'chol' or 'cg'")
    layouts, _, _ = _canonical(mesh)
    vl, w, h = _setup(v, k, mesh, layouts, nndsvd_init=nndsvd_init, w_init=w_init,
                      h_init=h_init, key=key, elevate=False)
    if use_pallas is None:
        use_pallas = vl.device.type == "cuda"
    kernels = bool(use_pallas) and vl.dtype == torch.float32 and objective_takes(vl, k)
    sums = MeshSums(mesh)
    experiment = AdmmExperiment(
        method="admm", components=k, rho=rho, distance_type=distance_type,
        nndsvd_init=nndsvd_init, min_iter=min_iter, max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=reg_w[0], prox_w=reg_w[1], lambda_h=reg_h[0], prox_h=reg_h[1])
    with torch.no_grad(), full_f32():
        rho0 = torch.as_tensor(rho, dtype=vl.dtype, device=vl.device)
        zeros_wh = (torch.zeros_like(w), torch.zeros_like(h))
        inner = (w, h, w, h, *zeros_wh)
        if distance_type == "kl":
            inner += (torch.zeros_like(vl), torch.zeros_like(vl))
        obj0 = sums.psum(distance(vl, w @ h, distance_type), "rows", "cols")
    carry = _admm_block(vl, init_carry(obj0, max_iter, inner + (rho0,)), max_iter, tol1,
                        tol2, reg_w[0], reg_h[0], rho_tau, rho_mu,
                        distance_type=distance_type, prox_w=reg_w[1], prox_h=reg_h[1],
                        rho_mode=rho_mode, spd_solver=spd_solver, min_iter=min_iter,
                        max_iter=max_iter, use_pallas=kernels,
                        verbose=verbose_precision(verbose, tol1, tol2), sums=sums)
    return _gathered(mesh, carry, carry.inner[0], carry.inner[1], experiment)


def ao_admm_mesh(v, k: int, mesh, *, distance_type: str = "eu", reg_w=(0, "nn"),
                 reg_h=(0, "l2n"), min_iter: int = 10, max_iter: int = 100000,
                 admm_iter: int = 10, tol1: float = 1e-3, tol2: float = 1e-3,
                 nndsvd_init=(True, "zero"), save_dir: str = "./results/",
                 rho_mode: str = "fixed", rho_tau: float = 2.0, rho_eta: float = 10.0,
                 upper_bound: float = 1.0, spd_solver=None, w_init=None, h_init=None,
                 key=None, use_pallas=None, verbose: bool = False, **unported):
    """``solvers.ao_admm`` over a mesh: each inner ADMM's W^T Y and Gram
    all-reduced over its frame's rows (V's rows for H, V's columns for the
    W subproblem on V^T), its stop test and adaptive rho on norms of the
    whole factor, the KL split on the rank's block; the local-sparsity W
    update's products over 'cols' and its norms over the axes that split
    them."""
    _refuse(unported, "ao_admm")
    if distance_type not in ("eu", "kl"):
        raise TypeError("Unknown loss function type.")
    if rho_mode not in ("fixed", "adaptive"):
        raise ValueError("rho_mode must be 'fixed' or 'adaptive'")
    local_sparsity = rho_mode == "adaptive" and reg_w[1] == "l1inf"
    spd_solver = "chol" if spd_solver is None else spd_solver
    if spd_solver not in ("chol", "cg"):
        raise ValueError("spd_solver must be 'chol' or 'cg'")
    layouts, _, _ = _canonical(mesh)
    vl, w, h = _setup(v, k, mesh, layouts, nndsvd_init=nndsvd_init, w_init=w_init,
                      h_init=h_init, key=key, elevate=False)
    if vl.dtype == torch.bfloat16:
        raise NotImplementedError(
            "Unsupported dtype bfloat16: AO-ADMM's Cholesky and NNDSVD take float32 "
            "or float64 V, as in tpunmf")
    if use_pallas is None:
        use_pallas = vl.device.type == "cuda"
    kernels = bool(use_pallas) and vl.dtype == torch.float32 and objective_takes(vl, k)
    sums = MeshSums(mesh)
    experiment = AoAdmmExperiment(
        method="ao_admm", components=k, distance_type=distance_type,
        nndsvd_init=nndsvd_init, min_iter=min_iter, max_iter=max_iter,
        admm_iter=admm_iter, tol1=tol1, tol2=tol2, lambda_w=reg_w[0], prox_w=reg_w[1],
        lambda_h=reg_h[0], prox_h=reg_h[1])
    with torch.no_grad(), full_f32():
        zw, zh = torch.zeros_like(w), torch.zeros_like(h)
        inner = (w, h, w, zw, zh) if local_sparsity else (w, h, zw, zh)
        if distance_type == "kl":
            inner += (torch.zeros_like(vl), torch.zeros_like(vl))
        obj0 = sums.psum(distance(vl, w @ h, distance_type), "rows", "cols")
    carry = _ao_admm_block(
        vl, init_carry(obj0, max_iter, inner), max_iter, tol1, tol2, reg_w[0], reg_h[0],
        rho_tau, rho_eta, upper_bound, k=k, distance_type=distance_type, prox_w=reg_w[1],
        prox_h=reg_h[1], rho_mode=rho_mode, local_sparsity=local_sparsity,
        spd_solver=spd_solver, min_iter=min_iter, max_iter=max_iter, admm_iter=admm_iter,
        use_pallas=kernels, verbose=verbose_precision(verbose, tol1, tol2), sums=sums)
    return _gathered(mesh, carry, carry.inner[0], carry.inner[1], experiment)


def mur_masked_mesh(x, mask, k: int, mesh, *, distance_type: str = "kl", min_iter: int = 100,
                    max_iter: int = 100000, tol1: float = 1e-5, tol2: float = 1e-5,
                    lambda_w: float = 0.0, lambda_h: float = 0.0,
                    nndsvd_init=(False, "zero"), w_init=None, h_init=None, key=None,
                    use_pallas=None, verbose: bool = False, **unported):
    """``solvers.mur_masked`` over a mesh: X and the mask cut by X's
    layout; each half on its masked kernel where its contraction axis is
    absent or of size 1 (and the kernels take X and k), else its two
    products on the rank's block, summed over the axis, then the closed
    form; the masked objective's partials over both axes."""
    _refuse(unported, "mur with mask=")
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if mask is None:
        raise ValueError("mur_masked requires a mask; use mur() without one")
    if tuple(mask.shape) != tuple(x.shape):
        raise ValueError(f"mask shape {tuple(mask.shape)} != data shape {tuple(x.shape)}")
    layouts, rows, cols = _canonical(mesh)
    xl = place(mesh, x, layouts[0])
    ml = place(mesh, mask, layouts[0]).to(xl.dtype)
    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    kernels = bool(use_pallas) and masked_takes(xl, k)
    sums = MeshSums(mesh)
    lam_w, lam_h = float(lambda_w), float(lambda_h)
    experiment = MurExperiment(method="mur", components=k, distance_type=distance_type,
                               nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1,
                               tol2=tol2, lambda_w=lambda_w, lambda_h=lambda_h)
    objective = _masked_kl_obj if distance_type == "kl" else _masked_eu_obj
    with torch.no_grad(), full_f32():
        # negative-data elevation over the OBSERVED cells only
        inf = torch.full_like(xl, float("inf"))
        low = _reduce_mesh(mesh, torch.min(torch.where(ml > 0, xl, inf)).reshape(1),
                           dist.ReduceOp.MIN)
        shift = torch.clamp(-low[0], min=0.0)
        xl = (xl + shift).contiguous()
        del inf

        def nndsvd_data():  # NNDSVD on the zero-filled observed matrix
            xg = place(mesh, x, (None, None)) + shift
            return xg * place(mesh, mask, (None, None)).to(xg.dtype)

        w, h = global_inits(mesh, *x.shape, k, xl.dtype, nndsvd_init=nndsvd_init,
                            w_init=w_init, h_init=h_init, key=key, nndsvd_data=nndsvd_data)
        w, h = local_block(mesh, w, layouts[1]), local_block(mesh, h, layouts[2])
        if kernels:
            if xl.dtype == torch.bfloat16:
                w, h = w.float(), h.float()
            # one byte a cell where the whole mask is binary, as on one device
            binary = torch.all((ml == 0) | (ml == 1)).to(torch.float32).reshape(1)
            if bool(_reduce_mesh(mesh, binary, dist.ReduceOp.MIN)[0]):
                ml = ml.to(torch.uint8)
        w, h, ml = w.contiguous(), h.contiguous(), ml.contiguous()
        obj0 = sums.psum(objective(xl, ml, w, h), "rows", "cols")

    w_local = kernels and _local_half(mesh, cols)
    h_local = kernels and _local_half(mesh, rows)

    def step(inner, i):
        w, h = inner
        if w_local:
            w = masked_w_update(xl, ml, w, h, distance_type=distance_type, lam=lam_w)
        else:
            num, den = masked_w_parts(xl, ml, w, h, distance_type=distance_type)
            w = masked_w_closed(w, sums.psum(num, "cols"), sums.psum(den, "cols"),
                                distance_type=distance_type, lam=lam_w)
        if h_local:
            h = masked_h_update(xl, ml, w, h, distance_type=distance_type, lam=lam_h)
        else:
            num, den = masked_h_parts(xl, ml, w, h, distance_type=distance_type)
            h = masked_h_closed(h, sums.psum(num, "rows"), sums.psum(den, "rows"),
                                distance_type=distance_type, lam=lam_h)
        return (w, h), sums.psum(objective(xl, ml, w, h), "rows", "cols")

    with torch.no_grad(), full_f32():
        carry = while_block(step, init_carry(obj0, max_iter, (w, h)), max_iter, tol1, tol2,
                            min_iter=min_iter, max_iter=max_iter, verbose=verbose)
    return _gathered(mesh, carry, *carry.inner, experiment)
