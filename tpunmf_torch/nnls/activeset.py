"""Batched masked active-set NNLS (FCNNLS re-derived for batches).

Same contract as ``tpunmf.nnls.activeset``: solves
``min_{K >= 0} ||C K - A||_F`` from the normal-equation inputs
``CtC = C.T @ C`` and ``CtA = C.T @ A`` for all right-hand-side columns at
once.  Passive sets are (l, p) boolean masks; the per-set grouped solves
are ONE batched masked solve, ``(CtC ⊙ m m^T + diag(~m)) k = CtA ⊙ m`` per
column, so entries outside the passive set solve to exactly 0; the
feasibility line search runs over all columns at once, and converged
columns are frozen by done-masks.

``tpunmf`` runs the outer and inner loops as ``lax.while_loop``s on its
device.  Here they are host loops: each trip reads ``any(f_mask)`` (outer)
or ``any(h_mask)`` (inner) to the host, one sync a trip and no other.  The
batched Cholesky is ``torch.linalg.cholesky_ex``, which checks nothing on
the host; a column whose factorization failed comes out NaN, as in JAX.
``trips`` counts the calls and each loop's trips for the tests and
``chip_smoke.py``; the results do not carry them.

Matmul precision: every product here runs with TF32 off
(``core/precision.full_f32``), the port's counterpart of ``tpunmf``'s
'highest'.  ``precision`` (CG path and duals, as in ``tpunmf``) takes
None, 'highest' or 'float32' (TF32 off) or 'high' / 'tensorfloat32' (TF32
allowed for the rank-sized CG matvecs and duals only); other values
raise.
"""
from __future__ import annotations

import contextlib
import math
from functools import partial, wraps

import torch

from ..core.linalg import spd_solve
from ..core.precision import full_f32

# cap on the (p, l, l) batched-system temporary built per solve
_MASKED_SOLVE_BYTES_BUDGET = 512 * 1024 * 1024

_FULL_F32 = (None, "highest", "float32")
_TF32 = ("high", "tensorfloat32")


class Trips:
    """Counts of NNLS calls (one per half-step in ANLS) and of the loops'
    trips, each of which reads one flag to the host."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = self.outer = self.inner = self.bpp = 0

    def as_dict(self):
        return {"calls": self.calls, "outer": self.outer, "inner": self.inner,
                "bpp": self.bpp}


trips = Trips()


@contextlib.contextmanager
def _tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _prec_ctx(precision):
    """The matmul scope of the rank-sized internals; an unknown precision
    raises."""
    if precision not in _FULL_F32 + _TF32:
        raise ValueError(f"precision must be one of {_FULL_F32 + _TF32}; got {precision!r}")
    return _tf32() if precision in _TF32 else full_f32()


def _exact(fn):
    """Run ``fn`` without autograd and with TF32 off."""
    @wraps(fn)
    def run(*args, **kw):
        with torch.no_grad(), full_f32():
            return fn(*args, **kw)
    return run


def _masked_solve_block(ct_c, ct_a_t, m):
    """(chunk, l) rhs/masks -> (chunk, l) solutions.

    Each masked system is SPD (a principal submatrix of an SPD Gram plus
    identity padding), so batched Cholesky applies.  The (chunk, l, l)
    systems are built in one buffer that the factor then replaces."""
    mats = m[:, :, None] * m[:, None, :]
    mats.mul_(ct_c)
    mats.diagonal(dim1=1, dim2=2).add_(1.0 - m)
    rhs = (ct_a_t * m)[:, :, None]
    chol, info = torch.linalg.cholesky_ex(mats)
    del mats
    sol = torch.linalg.solve_triangular(chol, rhs, upper=False)
    sol = torch.linalg.solve_triangular(chol.mT, sol, upper=True)[:, :, 0]
    return torch.where((info != 0)[:, None], math.nan, sol)


def masked_solve(ct_c, ct_a, p_set, *, x0=None):
    """Batched solve of per-column passive-set subsystems.

    For column j with passive mask m: solves
    ``(CtC ⊙ m m^T + diag(~m)) k_j = CtA_j ⊙ m``; rows outside the passive
    set reduce to ``1 * k_i = 0``.  Where the (p, l, l) systems would
    exceed a fixed memory budget, the columns are solved in chunks, one
    after the other.

    Args:
      ct_c: (l, l); ct_a: (l, p); p_set: (l, p) bool.
      x0: ignored (direct solve), accepted so call sites can pass a warm
        start to either solve method.
    Returns: (l, p) solution with zeros outside the passive sets.
    """
    del x0
    l, p = ct_a.shape
    m = p_set.T.to(ct_a.dtype)                     # (p, l)
    ct_a_t = ct_a.T                                # (p, l)
    per_column = l * l * ct_a.element_size()
    if p * per_column <= _MASKED_SOLVE_BYTES_BUDGET:
        return _masked_solve_block(ct_c, ct_a_t, m).T
    chunk = max(1, _MASKED_SOLVE_BYTES_BUDGET // per_column)
    return torch.cat([_masked_solve_block(ct_c, ct_a_t[s:s + chunk], m[s:s + chunk])
                      for s in range(0, p, chunk)]).T


def masked_solve_cg(ct_c, ct_a, p_set, *, iters: int = 0, x0=None,
                    precision: str | None = None):
    """Masked per-column solves by Jacobi-preconditioned CG.

    The masked matvec of every column at once,
    ``A_j v_j = m_j ⊙ (CtC @ (m_j ⊙ v_j)) + (1-m_j) ⊙ v_j``, is one dense
    (l, l) @ (l, p) product plus elementwise masks.  ``iters`` defaults to
    l + 8 (exact in exact arithmetic); ``x0`` warm-starts the iteration
    (masked onto the passive set) at the cost of one extra matvec.  A fixed
    step count: no host read.  Same signature and semantics as
    :func:`masked_solve`.
    """
    with _prec_ctx(precision):
        return _masked_solve_cg_body(ct_c, ct_a, p_set, iters=iters, x0=x0)


def _masked_solve_cg_body(ct_c, ct_a, p_set, *, iters, x0):
    l, p = ct_a.shape
    if iters == 0:
        iters = l + 8
    m = p_set.to(ct_a.dtype)                      # (l, p)
    b = m * ct_a
    diag = m * torch.diagonal(ct_c)[:, None] + (1.0 - m)  # Jacobi preconditioner
    diag = torch.where(diag <= 0.0, 1.0, diag)             # singular-Gram guard

    def matvec(v):
        return m * (ct_c @ (m * v)) + (1.0 - m) * v

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = m * x0.to(ct_a.dtype)
        r = b - matvec(x)
    z = r / diag
    pvec = z
    rz = torch.sum(r * z, dim=0)                  # (p,)
    for _ in range(iters):
        ap = matvec(pvec)
        denom = torch.sum(pvec * ap, dim=0)
        alpha = rz / torch.where(denom == 0.0, 1.0, denom)
        x = x + alpha[None, :] * pvec
        r = r - alpha[None, :] * ap
        z = r / diag
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / torch.where(rz == 0.0, 1.0, rz)
        pvec = z + beta[None, :] * pvec
        rz = rz_new
    return x


def _one_hot_cols(idx, l):
    """(p,) indices -> (l, p) bool one-hot (``jax.nn.one_hot(idx, l, axis=0)``)."""
    return torch.arange(l, device=idx.device)[:, None] == idx[None, :]


def _dead_guard(ct_c, ct_a):
    """Dead components: CtC_ll == 0 means column l of C is identically zero
    (CtC is PSD, so its whole row and column are zero), e.g. an all-zero
    NNDSVD-init factor row.  Their exact NNLS coefficient is 0; a unit
    diagonal and a zero right-hand side give exactly that, where the
    singular system would NaN the whole batch."""
    dead = torch.diagonal(ct_c) <= 0.0
    ct_c = ct_c + torch.diag(dead.to(ct_c.dtype))
    ct_a = torch.where(dead[:, None], 0.0, ct_a)
    return ct_c, ct_a


@_exact
def nnls_activeset(ct_c, ct_a, p_set0=None, k0=None, *, max_outer: int = 0,
                   inner_cap: int = 0, solve_method: str = "chol",
                   opt_tol_ulps: float = 100.0,
                   freeze_stalled: bool = True, cg_iters: int = 0,
                   precision: str | None = None):
    """Batched NNLS via masked active sets (``tpunmf``'s arguments).

    Args:
      ct_c: (l, l) Gram matrix (SPD; add a ridge upstream if rank-deficient).
      ct_a: (l, p) cross-products, one column per right-hand side.
      p_set0: optional (l, p) bool warm-start passive sets (e.g. the
        support of the previous ANLS iterate); the fixed point is the
        unique NNLS optimum either way.
      k0: optional (l, p) warm-start values (requires p_set0): CG solves
        start from the masked k0.  Ignored by 'chol'.
      max_outer: bound on outer optimality trips (default 5*l + 10).
      inner_cap: feasibility-restoration budget shared by all outer trips
        (default 3*l).
      solve_method: 'chol' (batched Cholesky, exact) or 'cg'.
      opt_tol_ulps: CG-path dual optimality slack in ulps of the dtype
        (exact solves test ``<= 0``).
      cg_iters: CG steps per solve (0 = the exact bound l + 8).
      precision: matmul scope of the CG matvecs and the duals (module
        docstring).
      freeze_stalled: retire a column whose NNLS objective fails to
        decrease by more than ~64 ulps (relative) across an exchange: it
        is at its numerical optimum and would cycle on rounding noise.

    Returns: (l, p) non-negative minimizer.
    """
    _prec_ctx(precision)  # an unknown precision raises before any work
    if solve_method == "chol":
        _solve = masked_solve
    else:
        _solve = partial(masked_solve_cg, iters=cg_iters, precision=precision)
    l, p = ct_a.shape
    if k0 is not None and p_set0 is None:
        raise ValueError("k0 warm-start values require p_set0")
    if max_outer == 0:
        max_outer = 5 * l + 10
    if inner_cap == 0:
        inner_cap = 3 * l
    trips.calls += 1

    ct_c, ct_a = _dead_guard(ct_c, ct_a)
    dtype, dev = ct_a.dtype, ct_a.device
    eps = torch.finfo(dtype).eps

    if p_set0 is None:
        # unconstrained seed + initial passive sets (fcnnls steps 4-7)
        k0 = spd_solve(ct_c, ct_a, method=solve_method)
        p_set = k0 > 0
        k = torch.where(p_set, k0, 0.0)
        d = k
        f_mask = ~torch.all(p_set, dim=0)  # columns still active (step 6)
    else:
        p_set = p_set0
        k = _solve(ct_c, ct_a, p_set, x0=k0)
        d = torch.clamp(k, min=0.0)
        f_mask = torch.ones((p,), dtype=torch.bool, device=dev)  # optimality decides
    warm = p_set0 is not None

    if solve_method == "cg":
        # ~100 ulps at the working precision: f32 gets ~1e-5 relative
        # slack (CG noise floor), f64 stays effectively exact
        opt_tol = opt_tol_ulps * eps * (torch.amax(torch.abs(ct_a), dim=0) + 1e-30)
    else:
        opt_tol = torch.zeros((p,), dtype=dtype, device=dev)
    q_prev = torch.full((p,), math.inf, dtype=dtype, device=dev)
    inner_it = it = 0
    while it < max_outer and bool(f_mask.any()):
        trips.outer += 1
        if not (warm and it == 0):
            # a warm start's first solve happened above, on the same p_set
            k = torch.where(f_mask[None, :], _solve(ct_c, ct_a, p_set, x0=k), k)

        # feasibility restoration (inner loop, fcnnls steps 10-13)
        h_mask = torch.logical_and(f_mask, torch.any(k < 0, dim=0))
        while inner_it < inner_cap and bool(h_mask.any()):
            trips.inner += 1
            # alpha step toward feasibility for negative passive variables
            neg = torch.logical_and(p_set, k < 0)
            alpha = torch.where(neg, d / (d - k), math.inf)
            alpha_min, min_idx = torch.min(alpha, dim=0)      # first index on ties
            d_new = d - alpha_min[None, :] * (d - k)
            hit = torch.logical_and(_one_hot_cols(min_idx, l), h_mask[None, :])
            d_new = torch.where(hit, 0.0, d_new)
            d = torch.where(h_mask[None, :], d_new, d)
            p_set = torch.logical_and(p_set, ~hit)
            k = torch.where(h_mask[None, :], _solve(ct_c, ct_a, p_set, x0=k), k)
            h_mask = torch.any(k < 0, dim=0)
            inner_it += 1

        # optimality via the dual w = CtA - CtC @ K; the exact <= 0 test for
        # exact solves, a scale-relative slack for CG's noisy duals
        with _prec_ctx(precision):
            w_grad = ct_a - ct_c @ k
        grad_off = torch.where(p_set, 0.0, w_grad)
        optimal = torch.all(grad_off <= opt_tol[None, :], dim=0)
        f_mask = torch.logical_and(f_mask, ~optimal)

        if freeze_stalled:
            # per-column NNLS objective (up to ||a_j||^2):
            # q_j = 0.5 k^T CtC k - k^T cta = -0.5 * sum(k * (cta + w_grad)),
            # strictly decreasing for exact exchanges
            q = -0.5 * torch.sum(torch.clamp(k, min=0.0) * (ct_a + w_grad), dim=0)
            tol = 64.0 * eps * (torch.abs(q_prev) + 1e-30)
            stalled = q >= q_prev - tol
            if it > 0:
                f_mask = torch.logical_and(f_mask, ~stalled)
            q_prev = torch.where(f_mask, q, q_prev)

        # grow the passive set by the steepest off-set gradient per column
        grad_neg_inf = torch.where(p_set, -math.inf, w_grad)
        mx_idx = torch.argmax(grad_neg_inf, dim=0)            # first index on ties
        grow = torch.logical_and(_one_hot_cols(mx_idx, l), f_mask[None, :])
        p_set = torch.logical_or(p_set, grow)
        d = torch.where(f_mask[None, :], k, d)
        it += 1
    return torch.clamp(k, min=0.0)


def nnls(c, a, **kw):
    """Convenience wrapper from raw (C, A): forms the normal equations."""
    with torch.no_grad(), full_f32():
        return nnls_activeset(c.T @ c, c.T @ a, **kw)
