"""The solvers over a mesh: the facade's ``mesh=`` for HALS, ANLS, ADMM,
AO-ADMM, masked and beta-divergence MUR, semi-NMF, ONMF, robust NMF, N-way
CP and the multilevel warm start (MUR's own is ``sharded_solvers.mur_mesh``).

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

semi-NMF, ONMF, robust NMF and beta= run their one-device steps with
``MeshSums`` too; robust NMF sums W^T X, W^T W and ||x_j||^2 over 'rows'
before it reads a column norm, so every rank of a column block weights
its columns with the same d.  ``ntf_mesh`` splits X's modes 0 and 1 over
'rows' and 'cols' (``tpunmf``'s facade layout), factor 0 over 'rows' and
factor 1 over 'cols'.  ``multilevel_mesh`` runs ``mur_mesh`` or
``hals_mesh`` on each level's global coarse X.  A mirror problem (ONMF's
``orthogonal="w"``, multilevel's ``axis=0``) runs on X^T with the mesh's
roles swapped (``frame=MeshSums(mesh).T``).

Every rank passes the global host data and gets the same ``Results``,
the factors gathered to the host.  Inits are the given ones, or made on
rank 0 and broadcast.  Every driver takes its one-device solver's
keywords, blocks and checkpoints included: its carry holds the
one-device leaves in their order, each split leaf as the rank's block,
and ``mesh_checkpoint.MeshStore`` saves it as the one-device ``.npz``
(or, with ``checkpoint_backend="dcp"``, a sharded DCP directory).
``verbose`` prints on rank 0.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from ..core.losses import distance
from ..core.precision import full_f32
from ..core.sums import Sums
from ..core.types import (AdmmExperiment, AnlsExperiment, AoAdmmExperiment, MurExperiment,
                          Results)
from ..init.random import make_generator
from ..ops.fused import eu_residual_obj, eu_residual_obj_ref, objective_takes
from ..ops.hals_sweep import gs_sweep, gs_sweep_ref, sweep_takes
from ..ops.masked_fused import (masked_h_closed, masked_h_parts, masked_h_update, masked_takes,
                                masked_w_closed, masked_w_parts, masked_w_update)
from ..solvers import cuda_defaults
from ..solvers.admm import _admm_block
from ..solvers.anls import _anls_block
from ..solvers.ao_admm import _ao_admm_block
from ..solvers.beta import _mur_beta_block, beta_divergence, check_init
from ..solvers.common import (finalize_history, host_array, init_carry, run_loop,
                              verbose_precision, while_block)
from ..solvers.hals import _EPS as _HALS_EPS, _hals_block
from ..solvers.masked import _masked_eu_obj, _masked_kl_obj
from ..solvers.onmf import _onmf_block
from ..solvers.robust import _column_residual_norms, _robust_block
from ..solvers.semi import _lstsq, _semi_block
from .collectives import all_gather, all_reduce_in_layout, broadcast
from .mesh import axis_index, axis_size, has_axis, local_block, mesh_device, place
from .mesh_checkpoint import MeshStore
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


def _frame(mesh, frame=None):
    """(sums, layouts) of a driver's frame: ``frame`` (a :class:`MeshSums`;
    ``MeshSums(mesh).T`` runs the mirror problem on X^T with the mesh's
    roles swapped) or the canonical one, and the layouts ``v``, ``w``,
    ``h`` it puts X, W and H in (``nmf_shardings`` in the canonical
    frame; an axis the mesh lacks is None)."""
    sums = MeshSums(mesh) if frame is None else frame
    rows, cols = (a if has_axis(mesh, a) else None
                  for a in (sums.axes["rows"], sums.axes["cols"]))
    return sums, dict(v=(rows, cols), w=(rows, None), h=(None, cols))


def _rank0(verbose):
    """A driver prints its trace on rank 0 only."""
    return verbose if dist.get_rank() == 0 else False


def _checkpointed(mesh, run, carry, layouts, *, max_iter, config_tag, block_size=None,
                  on_block_end=None, checkpoint_path=None, checkpoint_every=None,
                  resume=False, checkpoint_backend="npz"):
    """``solvers/common.run_loop`` over a mesh: blocks as on one device,
    checkpoints through :class:`MeshStore` (``layouts``: one a leaf of the
    carry's ``inner``).  ``on_block_end`` runs on every rank with the
    rank's carry, whose ``i``, ``obj``, ``converged`` and ``obj_buf`` every
    rank holds bit for bit, so a stop it asks for on those fields is taken
    by every rank at the same block."""
    return run_loop(run, carry, max_iter=max_iter, block_size=block_size,
                    on_block_end=on_block_end, checkpoint_path=checkpoint_path,
                    checkpoint_every=checkpoint_every, resume=resume, config_tag=config_tag,
                    store=MeshStore(mesh, layouts, checkpoint_backend))


def _gathered(mesh, carry, w, h, experiment, lay):
    """The same ``Results`` on every rank: W gathered over the axis that
    splits its rows, H over the one that splits its columns (``lay``:
    :func:`_frame`'s layouts)."""
    rows, cols = lay["w"][0], lay["h"][1]
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
              block_size=None, on_block_end=None, checkpoint_path=None,
              checkpoint_every=None, resume: bool = False, checkpoint_backend: str = "npz",
              frame=None):
    """``solvers.hals`` over a mesh: the W half's sweeps (``gs_sweep`` where
    the kernel takes X and k) on the rank's rows from X H^T (over 'cols')
    and H H^T, the H half's on its columns from W^T X and W^T W (over
    'rows'); the exact objective's partials (``eu_residual_obj``) over
    both axes, or the Gram form from an all-reduced ||X||^2.  The single
    pass (``hals_iteration_eu``) stays one-device.  ``frame``: see
    :func:`_frame` (multilevel's ``axis=0``)."""
    if distance_type != "eu":
        raise KeyError("HALS is Euclidean-only; use mur/admm for 'kl'.")
    if inner_sweeps < 1:
        raise ValueError("inner_sweeps must be >= 1")
    sums, lay = _frame(mesh, frame)
    xl, w, h = _setup(x, k, mesh, (lay["v"], lay["w"], lay["h"]), nndsvd_init=nndsvd_init,
                      w_init=w_init, h_init=h_init, key=key)
    if w_init is None:
        # HALS divides by Gram diagonals: no component may start frozen
        w, h = torch.clamp(w, min=_HALS_EPS), torch.clamp(h, min=_HALS_EPS)
    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    sweep_kernel = bool(use_pallas) and sweep_takes(xl, k)
    objective_kernel = (bool(use_pallas) and xl.dtype == torch.float32
                        and objective_takes(xl, k))
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

    def run(c, stop):
        return _hals_block(xl, xsq, c, stop, tol1, tol2, float(lambda_w), float(lambda_h),
                           min_iter=min_iter, max_iter=max_iter, inner_sweeps=inner_sweeps,
                           objective=objective, sweep_kernel=sweep_kernel,
                           objective_kernel=objective_kernel, verbose=_rank0(verbose),
                           sums=sums)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, (w, h)), [lay["w"], lay["h"]],
                          max_iter=max_iter,
                          config_tag=repr(experiment)
                          + f"|hals:sweeps={inner_sweeps},obj={objective}",
                          block_size=block_size, on_block_end=on_block_end,
                            checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, *carry.inner, experiment, lay)


def anls_mesh(x, k: int, mesh, *, distance_type: str = "eu", use_fcnnls: bool = False,
              lambda_w: float = 0.0, lambda_h: float = 0.0, min_iter: int = 10,
              max_iter: int = 1000, tol1: float = 1e-3, tol2: float = 1e-3,
              nndsvd_init=(True, "zero"), save_dir: str = "./results/",
              nnls_solver: str = "activeset", masked_solver=None, nnls_opts=None,
              w_init=None, h_init=None, key=None, use_pallas=None, device_loop=None,
              verbose: bool = False, block_size=None, on_block_end=None,
              checkpoint_path=None, checkpoint_every=None, resume: bool = False,
              checkpoint_backend: str = "npz"):
    """``solvers.anls`` over a mesh: H's columns solved on each rank from
    W^T W and its columns of W^T X (over 'rows'), W's rows from H H^T and
    its rows of H X^T (over 'cols'); the NNLS ('activeset' or 'bpp', with
    its warm start) on the rank's own columns; the objective's partials
    (``eu_residual_obj`` / ``kl_obj``) over both axes."""
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
    sums, lay = _frame(mesh)
    # ANLS does not elevate X; its random init is U[0, 1) (nmf/anls.py:104-105)
    xl, w, h = _setup(x, k, mesh, (lay["v"], lay["w"], lay["h"]), nndsvd_init=nndsvd_init,
                      w_init=w_init, h_init=h_init, key=key, kind="uniform", elevate=False)
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
    experiment = AnlsExperiment(method="anls", components=k, distance_type=distance_type,
                                nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1,
                                tol2=tol2, lambda_w=lambda_w, lambda_h=lambda_h,
                                fcnnls=use_fcnnls)
    with torch.no_grad(), full_f32():
        obj0 = sums.psum(distance(xl, w @ h, distance_type), "rows", "cols")

    def run(c, stop):
        return _anls_block(xl, c, stop, tol1, tol2, lambda_w, lambda_h, k=k,
                           distance_type=distance_type, nnls_solver=nnls_solver,
                           solve_method=masked_solver, nnls_opts=nnls_opts,
                           min_iter=min_iter, max_iter=max_iter, use_pallas=kernels,
                           verbose=_rank0(verbose_precision(verbose, tol1, tol2)), sums=sums)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, (w, h)), [lay["w"], lay["h"]],
                          max_iter=max_iter,
                          config_tag=repr(experiment) + f"|nnls={nnls_solver},{masked_solver},"
                          f"{tuple(sorted(nnls_opts.items()))}",
                          block_size=block_size, on_block_end=on_block_end,
                            checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, *carry.inner, experiment, lay)


def admm_mesh(v, k: int, mesh, *, rho: float = 1.0, distance_type: str = "eu",
              reg_w=(0, "nn"), reg_h=(0, "l2n"), min_iter: int = 10,
              max_iter: int = 100000, tol1: float = 1e-3, tol2: float = 1e-3,
              nndsvd_init=(True, "zero"), save_dir: str = "./results/",
              rho_mode: str = "fixed", rho_tau: float = 2.0, rho_mu: float = 10.0,
              spd_solver=None, w_init=None, h_init=None, key=None, use_pallas=None,
              verbose: bool = False, block_size=None, on_block_end=None,
              checkpoint_path=None, checkpoint_every=None, resume: bool = False,
              checkpoint_backend: str = "npz"):
    """``solvers.admm`` over a mesh: W_aux^T V and the k x k Grams over
    'rows' (H's side), H_aux V^T over 'cols' (W's side), the Cholesky
    solves replicated, V_aux, dual_V and the KL split on the rank's block,
    the objective (``eu_residual_obj`` / ``kl_ratio_and_obj``) and the
    adaptive rho's residual sums all-reduced."""
    if distance_type not in ("eu", "kl"):
        raise TypeError("Unknown loss type.")
    if rho_mode not in ("fixed", "adaptive"):
        raise ValueError("rho_mode must be 'fixed' or 'adaptive'")
    spd_solver = "chol" if spd_solver is None else spd_solver
    if spd_solver not in ("chol", "cg"):
        raise ValueError("spd_solver must be 'chol' or 'cg'")
    sums, lay = _frame(mesh)
    vl, w, h = _setup(v, k, mesh, (lay["v"], lay["w"], lay["h"]), nndsvd_init=nndsvd_init,
                      w_init=w_init, h_init=h_init, key=key, elevate=False)
    if use_pallas is None:
        use_pallas = vl.device.type == "cuda"
    kernels = bool(use_pallas) and vl.dtype == torch.float32 and objective_takes(vl, k)
    experiment = AdmmExperiment(
        method="admm", components=k, rho=rho, distance_type=distance_type,
        nndsvd_init=nndsvd_init, min_iter=min_iter, max_iter=max_iter, tol1=tol1,
        tol2=tol2, lambda_w=reg_w[0], prox_w=reg_w[1], lambda_h=reg_h[0], prox_h=reg_h[1])
    with torch.no_grad(), full_f32():
        rho0 = torch.as_tensor(rho, dtype=vl.dtype, device=vl.device)
        zeros_wh = (torch.zeros_like(w), torch.zeros_like(h))
        inner = (w, h, w, h, *zeros_wh)
        layouts = [lay["w"], lay["h"]] * 3
        if distance_type == "kl":
            inner += (torch.zeros_like(vl), torch.zeros_like(vl))
            layouts += [lay["v"]] * 2
        obj0 = sums.psum(distance(vl, w @ h, distance_type), "rows", "cols")

    def run(c, stop):
        return _admm_block(vl, c, stop, tol1, tol2, reg_w[0], reg_h[0], rho_tau, rho_mu,
                           distance_type=distance_type, prox_w=reg_w[1], prox_h=reg_h[1],
                           rho_mode=rho_mode, spd_solver=spd_solver, min_iter=min_iter,
                           max_iter=max_iter, use_pallas=kernels,
                           verbose=_rank0(verbose_precision(verbose, tol1, tol2)), sums=sums)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, inner + (rho0,)),
                          layouts + [None], max_iter=max_iter, config_tag=repr(experiment),
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, carry.inner[0], carry.inner[1], experiment, lay)


def ao_admm_mesh(v, k: int, mesh, *, distance_type: str = "eu", reg_w=(0, "nn"),
                 reg_h=(0, "l2n"), min_iter: int = 10, max_iter: int = 100000,
                 admm_iter: int = 10, tol1: float = 1e-3, tol2: float = 1e-3,
                 nndsvd_init=(True, "zero"), save_dir: str = "./results/",
                 rho_mode: str = "fixed", rho_tau: float = 2.0, rho_eta: float = 10.0,
                 upper_bound: float = 1.0, spd_solver=None, w_init=None, h_init=None,
                 key=None, use_pallas=None, verbose: bool = False, block_size=None,
                 on_block_end=None, checkpoint_path=None, checkpoint_every=None,
                 resume: bool = False, checkpoint_backend: str = "npz"):
    """``solvers.ao_admm`` over a mesh: each inner ADMM's W^T Y and Gram
    all-reduced over its frame's rows (V's rows for H, V's columns for the
    W subproblem on V^T), its stop test and adaptive rho on norms of the
    whole factor, the KL split on the rank's block; the local-sparsity W
    update's products over 'cols' and its norms over the axes that split
    them."""
    if distance_type not in ("eu", "kl"):
        raise TypeError("Unknown loss function type.")
    if rho_mode not in ("fixed", "adaptive"):
        raise ValueError("rho_mode must be 'fixed' or 'adaptive'")
    local_sparsity = rho_mode == "adaptive" and reg_w[1] == "l1inf"
    spd_solver = "chol" if spd_solver is None else spd_solver
    if spd_solver not in ("chol", "cg"):
        raise ValueError("spd_solver must be 'chol' or 'cg'")
    sums, lay = _frame(mesh)
    vl, w, h = _setup(v, k, mesh, (lay["v"], lay["w"], lay["h"]), nndsvd_init=nndsvd_init,
                      w_init=w_init, h_init=h_init, key=key, elevate=False)
    if vl.dtype == torch.bfloat16:
        raise NotImplementedError(
            "Unsupported dtype bfloat16: AO-ADMM's Cholesky and NNDSVD take float32 "
            "or float64 V, as in tpunmf")
    if use_pallas is None:
        use_pallas = vl.device.type == "cuda"
    kernels = bool(use_pallas) and vl.dtype == torch.float32 and objective_takes(vl, k)
    experiment = AoAdmmExperiment(
        method="ao_admm", components=k, distance_type=distance_type,
        nndsvd_init=nndsvd_init, min_iter=min_iter, max_iter=max_iter,
        admm_iter=admm_iter, tol1=tol1, tol2=tol2, lambda_w=reg_w[0], prox_w=reg_w[1],
        lambda_h=reg_h[0], prox_h=reg_h[1])
    with torch.no_grad(), full_f32():
        zw, zh = torch.zeros_like(w), torch.zeros_like(h)
        inner = (w, h, w, zw, zh) if local_sparsity else (w, h, zw, zh)
        layouts = ([lay["w"], lay["h"], lay["w"], lay["w"], lay["h"]] if local_sparsity
                   else [lay["w"], lay["h"]] * 2)
        if distance_type == "kl":
            inner += (torch.zeros_like(vl), torch.zeros_like(vl))
            layouts += [lay["v"]] * 2
        obj0 = sums.psum(distance(vl, w @ h, distance_type), "rows", "cols")

    def run(c, stop):
        return _ao_admm_block(
            vl, c, stop, tol1, tol2, reg_w[0], reg_h[0], rho_tau, rho_eta, upper_bound, k=k,
            distance_type=distance_type, prox_w=reg_w[1], prox_h=reg_h[1], rho_mode=rho_mode,
            local_sparsity=local_sparsity, spd_solver=spd_solver, min_iter=min_iter,
            max_iter=max_iter, admm_iter=admm_iter, use_pallas=kernels,
            verbose=_rank0(verbose_precision(verbose, tol1, tol2)), sums=sums)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, inner), layouts,
                          max_iter=max_iter,
                          # tpunmf appends rho_mode to the checkpoint tag
                          config_tag=repr(experiment) + (
                              f"+rho_mode={rho_mode}" if rho_mode != "fixed" else ""),
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, carry.inner[0], carry.inner[1], experiment, lay)


def mur_masked_mesh(x, mask, k: int, mesh, *, distance_type: str = "kl", min_iter: int = 100,
                    max_iter: int = 100000, tol1: float = 1e-5, tol2: float = 1e-5,
                    lambda_w: float = 0.0, lambda_h: float = 0.0,
                    nndsvd_init=(False, "zero"), w_init=None, h_init=None, key=None,
                    use_pallas=None, verbose: bool = False, block_size=None,
                    on_block_end=None, checkpoint_path=None, checkpoint_every=None,
                    resume: bool = False, checkpoint_backend: str = "npz"):
    """``solvers.mur_masked`` over a mesh: X and the mask cut by X's
    layout; each half on its masked kernel where its contraction axis is
    absent or of size 1 (and the kernels take X and k), else its two
    products on the rank's block, summed over the axis, then the closed
    form; the masked objective's partials over both axes."""
    if distance_type not in ("eu", "kl"):
        raise KeyError("Unknown distance type.")
    if mask is None:
        raise ValueError("mur_masked requires a mask; use mur() without one")
    if tuple(mask.shape) != tuple(x.shape):
        raise ValueError(f"mask shape {tuple(mask.shape)} != data shape {tuple(x.shape)}")
    sums, lay = _frame(mesh)
    layouts, rows, cols = (lay["v"], lay["w"], lay["h"]), lay["w"][0], lay["h"][1]
    xl = place(mesh, x, layouts[0])
    ml = place(mesh, mask, layouts[0]).to(xl.dtype)
    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    kernels = bool(use_pallas) and masked_takes(xl, k)
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

    def run(c, stop):
        with torch.no_grad(), full_f32():
            return while_block(step, c, stop, tol1, tol2, min_iter=min_iter,
                               max_iter=max_iter, verbose=_rank0(verbose))

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, (w, h)), [lay["w"], lay["h"]],
                          max_iter=max_iter, config_tag=repr(experiment) + "|masked",
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, *carry.inner, experiment, lay)


def _given_or_rank0(mesh, given, shape, dtype, make):
    """A global array on every rank: ``given`` (``as_input``'s rule, in
    ``dtype``), or ``make()`` on rank 0, broadcast."""
    if given is not None:
        return place(mesh, given, (None,) * len(shape), dtype=dtype)
    out = torch.empty(shape, dtype=dtype, device=mesh_device(mesh))
    if dist.get_rank() == 0:
        out.copy_(make())
    return broadcast(out)


def semi_nmf_mesh(x, k: int, mesh, *, min_iter: int = 20, max_iter: int = 1000,
                  tol1: float = 1e-5, tol2: float = 1e-5, lambda_h: float = 0.0, w_init=None,
                  h_init=None, key=None, use_pallas=None, verbose: bool = False,
                  block_size=None, on_block_end=None, checkpoint_path=None,
                  checkpoint_every=None, resume: bool = False,
                  checkpoint_backend: str = "npz"):
    """``solvers.semi_nmf`` over a mesh (mixed-sign X, nothing elevated):
    the W half's X H^T and H H^T summed over 'cols', the ridge solve
    replicated; the H half's W^T X and W^T W over 'rows', its split-sign
    update local; the objective (``eu_residual_obj``) over both axes.  The
    default init (|N(0, 1)| H from ``key``, W by least squares against the
    global X) is made on rank 0 and broadcast."""
    sums, lay = _frame(mesh)
    if (w_init is None) != (h_init is None) and w_init is not None:
        raise ValueError("pass h_init when passing w_init")
    xl = place(mesh, x, lay["v"])
    m, n = x.shape
    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    kernel = bool(use_pallas) and xl.dtype == torch.float32 and objective_takes(xl, k)
    objective = eu_residual_obj if kernel else eu_residual_obj_ref
    experiment = MurExperiment(method="semi_nmf", components=k, distance_type="eu",
                               nndsvd_init=(False, "zero"), max_iter=max_iter, tol1=tol1,
                               tol2=tol2, lambda_w=0.0, lambda_h=lambda_h)
    with torch.no_grad(), full_f32():
        def draw():
            g = make_generator(key, mesh_device(mesh))
            return torch.randn((k, n), generator=g, dtype=xl.dtype, device=g.device).abs_()

        h = _given_or_rank0(mesh, h_init, (k, n), xl.dtype, draw).contiguous()
        w = _given_or_rank0(mesh, w_init, (m, k), xl.dtype,
                            lambda: _lstsq(h.T, place(mesh, x, (None, None)).T).T)
        w = local_block(mesh, w, lay["w"]).contiguous()
        h = local_block(mesh, h, lay["h"]).contiguous()
        obj0 = sums.psum(objective(xl, w, h), "rows", "cols")

    def run(c, stop):
        return _semi_block(xl, c, stop, tol1, tol2, lambda_h, objective=objective,
                           min_iter=min_iter, max_iter=max_iter, verbose=_rank0(verbose),
                           sums=sums)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, (w, h)), [lay["w"], lay["h"]],
                          max_iter=max_iter, config_tag=repr(experiment) + "|semi",
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, *carry.inner, experiment, lay)


def _t(a):
    return None if a is None else a.T


def onmf_mesh(x, k: int, mesh, *, orthogonal: str = "h", min_iter: int = 20,
              max_iter: int = 1000, tol1: float = 1e-5, tol2: float = 1e-5,
              nndsvd_init=(False, "zero"), w_init=None, h_init=None, key=None,
              use_pallas=None, verbose: bool = False, block_size=None, on_block_end=None,
              checkpoint_path=None, checkpoint_every=None, resume: bool = False,
              checkpoint_backend: str = "npz", frame=None):
    """``solvers.onmf`` over a mesh: the W half's X H^T and H H^T over
    'cols', the orthogonal H half's W^T X over 'rows' and (W^T X) H^T over
    'cols', the objective over both axes.  ``orthogonal="w"`` runs the
    mirror problem on X^T with the mesh's roles swapped (``sums.T``), as one
    device runs it on X^T."""
    if orthogonal not in ("h", "w"):
        raise ValueError("orthogonal must be 'h' or 'w'")
    sums, lay = _frame(mesh, frame)
    if orthogonal == "w":
        res = onmf_mesh(x.T, k, mesh, orthogonal="h", min_iter=min_iter, max_iter=max_iter,
                        tol1=tol1, tol2=tol2, nndsvd_init=nndsvd_init, w_init=_t(h_init),
                        h_init=_t(w_init), key=key, use_pallas=use_pallas, verbose=verbose,
                        block_size=block_size, on_block_end=on_block_end,
                        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                        resume=resume, checkpoint_backend=checkpoint_backend, frame=sums.T)
        return Results(w=res.h.T, h=res.w.T, i=res.i, obj_history=res.obj_history,
                       experiment=res.experiment)
    xl, w, h = _setup(x, k, mesh, (lay["v"], lay["w"], lay["h"]), nndsvd_init=nndsvd_init,
                      w_init=w_init, h_init=h_init, key=key)
    if w_init is None and nndsvd_init[0]:
        # the sqrt update freezes exact zeros; nudge generated inits
        w, h = torch.clamp(w, min=1e-6).contiguous(), torch.clamp(h, min=1e-6).contiguous()
    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    kernel = bool(use_pallas) and xl.dtype == torch.float32 and objective_takes(xl, k)
    objective = eu_residual_obj if kernel else eu_residual_obj_ref
    experiment = MurExperiment(method="onmf", components=k, distance_type="eu-onmf",
                               nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1,
                               tol2=tol2, lambda_w=0.0, lambda_h=0.0)
    with torch.no_grad(), full_f32():
        obj0 = sums.psum(objective(xl, w, h), "rows", "cols")

    def run(c, stop):
        return _onmf_block(xl, c, stop, tol1, tol2, objective=objective, min_iter=min_iter,
                           max_iter=max_iter, verbose=_rank0(verbose), sums=sums)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, (w, h)), [lay["w"], lay["h"]],
                          max_iter=max_iter, config_tag=repr(experiment) + "|onmf",
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, *carry.inner, experiment, lay)


def _any_negative(mesh, t) -> bool:
    """Whether any rank's ``t`` has a negative entry (one host read, the
    same answer on every rank)."""
    flag = torch.any(t < 0).to(torch.float32).reshape(1)
    return bool(_reduce_mesh(mesh, flag, dist.ReduceOp.MAX)[0])


def robust_mesh(x, k: int, mesh, *, min_iter: int = 20, max_iter: int = 1000,
                tol1: float = 1e-5, tol2: float = 1e-5, nndsvd_init: tuple = (True, "zero"),
                w_init=None, h_init=None, key=None, verbose: bool = False, block_size=None,
                on_block_end=None, checkpoint_path=None, checkpoint_every=None,
                resume: bool = False, checkpoint_backend: str = "npz"):
    """``solvers.robust_nmf`` over a mesh: W^T X, W^T W and the columns'
    ||x_j||^2 summed over 'rows' before any residual norm is read, so every
    rank of a column block weights its columns with the same d; the W
    half's products over 'cols'; the l2,1 objective over 'cols'.  The
    non-negativity test is all-reduced, so every rank raises or none."""
    sums, lay = _frame(mesh)
    xl = place(mesh, x, lay["v"])
    if _any_negative(mesh, xl):
        raise ValueError("x must be non-negative")
    if (w_init is None) != (h_init is None):
        raise ValueError("provide both w_init and h_init or neither")
    w, h = global_inits(mesh, *x.shape, k, xl.dtype, nndsvd_init=nndsvd_init,
                        w_init=w_init, h_init=h_init,
                        key=None if nndsvd_init[0] else (42 if key is None else key),
                        nndsvd_data=lambda: place(mesh, x, (None, None)))
    w, h = local_block(mesh, w, lay["w"]), local_block(mesh, h, lay["h"])
    if w_init is None and nndsvd_init[0]:
        # multiplicative updates cannot leave zero cells: nudge exact zeros
        w, h = torch.clamp(w, min=1e-6), torch.clamp(h, min=1e-6)
    w, h = w.contiguous(), h.contiguous()
    experiment = MurExperiment(method="robust", components=k, distance_type="l21",
                               nndsvd_init=tuple(nndsvd_init), max_iter=max_iter, tol1=tol1,
                               tol2=tol2, lambda_w=0.0, lambda_h=0.0)
    with torch.no_grad(), full_f32():
        xsq_cols = sums.psum(torch.linalg.vector_norm(xl, dim=0).square(), "rows")
        obj0 = sums.psum(torch.sum(_column_residual_norms(
            xsq_cols, sums.psum(w.T @ xl, "rows"), sums.psum(w.T @ w, "rows"), h)), "cols")

    def run(c, stop):
        return _robust_block(xl, xsq_cols, c, stop, tol1, tol2, min_iter=min_iter,
                             max_iter=max_iter, verbose=_rank0(verbose), sums=sums)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, (w, h)), [lay["w"], lay["h"]],
                          max_iter=max_iter, config_tag=repr(experiment) + "|robust",
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, *carry.inner, experiment, lay)


def mur_beta_mesh(x, k: int, mesh, *, beta: float = 1.0, min_iter: int = 100,
                  max_iter: int = 100000, tol1: float = 1e-5, tol2: float = 1e-5,
                  lambda_w: float = 0.0, lambda_h: float = 0.0, nndsvd_init=(False, "zero"),
                  w_init=None, h_init=None, key=None, verbose: bool = False, block_size=None,
                  on_block_end=None, checkpoint_path=None, checkpoint_every=None,
                  resume: bool = False, checkpoint_backend: str = "npz"):
    """``solvers.mur_beta`` over a mesh: the powers of W H on the rank's
    block (a local product, k whole), each half's numerator and
    denominator summed over the axis it contracts, the divergence's
    partials over both axes; beta 0, 1 and 2 keep their own forms."""
    sums, lay = _frame(mesh)
    beta = float(beta)
    xl = place(mesh, x, lay["v"])
    low = _reduce_mesh(mesh, torch.min(xl).reshape(1), dist.ReduceOp.MIN)
    shift = torch.clamp(-low[0], min=0.0)
    xl = xl + shift
    dist_tag = {0.0: "is", 1.0: "kl", 2.0: "eu"}.get(beta, f"beta{beta:g}")
    experiment = MurExperiment(method="mur", components=k, distance_type=dist_tag,
                               nndsvd_init=nndsvd_init, max_iter=max_iter, tol1=tol1,
                               tol2=tol2, lambda_w=lambda_w, lambda_h=lambda_h)
    with torch.no_grad(), full_f32():
        w, h = global_inits(mesh, *x.shape, k, xl.dtype, nndsvd_init=nndsvd_init,
                            w_init=w_init, h_init=h_init, key=key,
                            nndsvd_data=lambda: place(mesh, x, (None, None)) + shift)
        if w_init is not None:
            check_init(w, h, beta)
        w, h = local_block(mesh, w, lay["w"]), local_block(mesh, h, lay["h"])
        if w_init is None and nndsvd_init[0] and beta < 1.0:
            w, h = torch.clamp(w, min=1e-6), torch.clamp(h, min=1e-6)
        w, h = w.contiguous(), h.contiguous()
        obj0 = sums.psum(beta_divergence(xl, w @ h, beta), "rows", "cols")

    def run(c, stop):
        return _mur_beta_block(xl, c, stop, tol1, tol2, lambda_w, lambda_h, beta=beta,
                               min_iter=min_iter, max_iter=max_iter, verbose=_rank0(verbose),
                               sums=sums)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, (w, h)), [lay["w"], lay["h"]],
                          max_iter=max_iter, config_tag=repr(experiment) + f"|beta={beta:g}",
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    return _gathered(mesh, carry, *carry.inner, experiment, lay)


def ntf_mesh(x, k: int, mesh, *, distance_type: str = "eu", update: str = "mur",
             lambdas=None, mask=None, min_iter: int = 10, max_iter: int = 500,
             tol1: float = 1e-5, tol2: float = 1e-5, factors_init=None, key=None,
             normalize: bool = True, use_pallas=None, verbose: bool = False, block_size=None,
             on_block_end=None, checkpoint_path=None, checkpoint_every=None,
             resume: bool = False, checkpoint_backend: str = "npz"):
    """``solvers.ntf`` over a mesh, on ``tpunmf``'s facade layout: X (and
    ``mask``) split over 'rows' along mode 0 and over 'cols' along mode 1
    (tpunmf/parallel/mesh.py:88-97), factor 0 split over 'rows', factor 1
    over 'cols', the others whole on every rank.  Mode d's MTTKRP is
    summed over the axes that split the other modes (mode 0's over 'cols',
    mode 1's over 'rows', the others' over both), each Gram and column sum
    over its own mode's axis, the normalization's column norms likewise,
    the objective over both; CP-HALS sweeps the rank's rows (``gs_sweep``
    where the port's ``ntf`` takes it).  The one-device ``ntf``'s
    semantics: ``normalize``, ``mask=``, ``lambdas``, the stopping rule and
    ``i``, blocks and checkpoints.  Random factors are drawn on rank 0 as
    ``ntf`` draws them (from the whole tensor's mean) and broadcast."""
    from ..solvers.ntf import (NtfExperiment, NtfResults, _axes, _initial_objective,
                               _ntf_block, check_mask, check_options, given_factors,
                               random_factors, strengths)

    shape = tuple(x.shape)
    ndim = len(shape)
    check_options(shape, distance_type, update)
    _axes(ndim)
    sums, lay = _frame(mesh)
    rows, cols = lay["v"]
    roles = ("rows", "cols") + (None,) * (ndim - 2)
    x_layout = (rows, cols) + (None,) * (ndim - 2)
    xl = place(mesh, x, x_layout)
    if _any_negative(mesh, xl):
        raise ValueError("x must be non-negative")
    ml = None
    if mask is not None:
        check_mask(mask, shape, update)
        ml = place(mesh, mask, x_layout, dtype=xl.dtype)
        if _any_negative(mesh, ml):
            raise ValueError("mask must be non-negative")
    lam = strengths(lambdas, ndim, xl.dtype, distance_type)
    factor_layouts = [(rows, None), (cols, None)] + [(None, None)] * (ndim - 2)
    dev = mesh_device(mesh)
    with torch.no_grad(), full_f32():
        if factors_init is not None:
            factors = given_factors(factors_init, shape, k,
                                    lambda f: place(mesh, f, (None, None), dtype=xl.dtype))
        else:
            factors = [torch.empty((s, k), dtype=xl.dtype, device=dev) for s in shape]
            if dist.get_rank() == 0:
                mean = torch.mean(place(mesh, x, (None,) * ndim, dtype=xl.dtype))
                for f, r in zip(factors, random_factors(mean, shape, k, key, xl.dtype, dev)):
                    f.copy_(r)
            for f in factors:
                broadcast(f)
        factors = tuple(local_block(mesh, f, fl).contiguous()
                        for f, fl in zip(factors, factor_layouts))
    experiment = NtfExperiment(method="ntf", components=k, distance_type=distance_type,
                               update=update, max_iter=max_iter, tol1=tol1, tol2=tol2,
                               lambdas=tuple(float(v) for v in lam))
    if use_pallas is None:
        use_pallas = xl.device.type == "cuda"
    sweep = gs_sweep if bool(use_pallas) and sweep_takes(xl, k) else gs_sweep_ref
    split = tuple(r for r in roles if r is not None)
    with torch.no_grad(), full_f32():
        flat = xl.reshape(-1)
        xsq = sums.psum(torch.dot(flat, flat), *split)
        obj0 = _initial_objective(xl, ml, xsq, factors, distance_type, sums, roles)

    def run(c, stop):
        return _ntf_block(xl, ml, xsq, lam, c, stop, tol1, tol2, distance_type=distance_type,
                          update=update, normalize=normalize, sweep=sweep, min_iter=min_iter,
                          max_iter=max_iter, verbose=_rank0(verbose), sums=sums, roles=roles)

    carry = _checkpointed(mesh, run, init_carry(obj0, max_iter, factors), factor_layouts,
                          max_iter=max_iter,
                          config_tag=(repr(experiment) + f"|ntf:shape={shape}"
                                      + ("|masked" if mask is not None else "")),
                          block_size=block_size, on_block_end=on_block_end,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume=resume, checkpoint_backend=checkpoint_backend)
    fs = list(carry.inner)
    if rows is not None:
        fs[0] = all_gather(fs[0], mesh, rows, dim=0)
    if cols is not None:
        fs[1] = all_gather(fs[1], mesh, cols, dim=0)
    i, obj_history = finalize_history(carry)
    return NtfResults(factors=[host_array(f) for f in fs], i=i, obj_history=obj_history,
                      experiment=experiment)


def multilevel_mesh(x, k: int, mesh, *, method: str = "hals", levels: int = 2,
                    factor: int = 4, coarse_iters: int = 200, axis: int = 1, key=None,
                    frame=None, **params):
    """``solvers.multilevel`` over a mesh: every level runs ``mur_mesh`` or
    ``hals_mesh`` on that level's global coarse data (each rank coarsens
    the global X), the coarsest from the solver's own default init, each
    finer level from the prolongated factors.  ``axis=0`` runs the mirror
    problem on X^T with the mesh's roles swapped.  Every level's X is cut
    into even blocks: a level whose columns (or rows) do not divide the
    axis that splits them raises ``ValueError`` naming the level, where
    ``tpunmf``'s GSPMD run pads."""
    from ..solvers.multilevel import (build_pyramid, check_levels, solve_up, swapped,
                                      transposed)
    from .sharded_solvers import mur_mesh

    check_levels(levels, factor)
    sums, lay = _frame(mesh, frame)
    if axis == 0:
        return transposed(multilevel_mesh(x.T, k, mesh, method=method, levels=levels,
                                          factor=factor, coarse_iters=coarse_iters, axis=1,
                                          key=key, frame=sums.T, **swapped(params)))
    table = {"mur": mur_mesh, "hals": hals_mesh}
    if method not in table:
        raise KeyError(f"multilevel supports {sorted(table)}; got {method!r}")
    pyramid = build_pyramid(place(mesh, x, (None, None)), k, levels, factor)
    rows, cols = lay["v"]
    for level, xc in enumerate(pyramid):
        for size, name in ((xc.shape[0], rows), (xc.shape[1], cols)):
            if name is not None and size % axis_size(mesh, name):
                raise ValueError(
                    f"multilevel level {level}: X of shape {tuple(xc.shape)} does not divide "
                    f"the '{name}' axis ({axis_size(mesh, name)}); the mesh runs even blocks")
    return solve_up(functools.partial(table[method], mesh=mesh, frame=frame), pyramid, k,
                    factor, coarse_iters, key, params)
