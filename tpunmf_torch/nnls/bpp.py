"""Batched block principal pivoting NNLS (Kim & Park).

Same contract as ``tpunmf.nnls.bpp``: per column j, partition the
variables into passive F and active G; solve x_F from CtC_FF, set
y_G = CtC_G. x - CtA_G; the infeasible set is
V = {i in F : x_i < 0} ∪ {i in G : y_i < 0}; full exchange while |V|
shrinks, a 'backup' budget of 3 full exchanges otherwise, then Murty's
single-variable rule (toggle the largest-index infeasible variable), which
guarantees termination.

All sets are boolean masks, the exchange is a vectorized XOR, and the
per-column state (best |V|, backup budget) is carried in integer vectors.
``tpunmf``'s ``lax.while_loop`` over the batch is a host loop here, one
read of ``any(V)`` a trip (counted in ``activeset.trips.bpp``).
"""
from __future__ import annotations

import torch

from .activeset import (_dead_guard, _exact, _one_hot_cols, masked_solve, masked_solve_cg,
                        trips)


@_exact
def nnls_bpp(ct_c, ct_a, f_set0=None, *, max_iter: int = 0,
             backup_budget: int = 3, solve_method: str = "chol"):
    """Batched NNLS via block principal pivoting.

    Args and returns as :func:`tpunmf_torch.nnls.nnls_activeset`;
    ``f_set0`` warm-starts the passive partition (answer unchanged).
    """
    l, p = ct_a.shape
    if max_iter == 0:
        max_iter = 10 * l + 50
    _solve = masked_solve if solve_method == "chol" else masked_solve_cg
    trips.calls += 1

    ct_c, ct_a = _dead_guard(ct_c, ct_a)
    dev = ct_a.device
    if f_set0 is None:
        # start from the all-active partition (x = 0, y = -CtA)
        f_set = torch.zeros((l, p), dtype=torch.bool, device=dev)
        x = torch.zeros_like(ct_a)
        y = -ct_a
    else:
        f_set = f_set0
        x = _solve(ct_c, ct_a, f_set)
        y = torch.where(f_set, 0.0, ct_c @ x - ct_a)
    ninf = torch.full((p,), l + 1, dtype=torch.int32, device=dev)   # best |V| so far
    backup = torch.full((p,), backup_budget, dtype=torch.int32, device=dev)

    it = 0
    while it < max_iter:
        v = torch.logical_or(torch.logical_and(f_set, x < 0),
                             torch.logical_and(~f_set, y < 0))
        if not bool(v.any()):
            break
        trips.bpp += 1
        nv = torch.sum(v, dim=0, dtype=torch.int32)       # (p,)
        active_cols = nv > 0

        improved = nv < ninf
        ninf = torch.where(improved, nv, ninf)
        backup_new = torch.where(improved, backup_budget, backup)
        use_full = torch.logical_or(improved, backup > 0)
        backup = torch.where(torch.logical_and(~improved, backup > 0), backup - 1,
                             backup_new)

        # Murty's rule: toggle only the largest-index infeasible variable
        # (argmax takes no bool; the first index on ties, 0 for none)
        rev_first = torch.argmax(torch.flip(v, (0,)).to(torch.uint8), dim=0)
        murty = _one_hot_cols((l - 1) - rev_first, l)

        toggle = torch.where(use_full[None, :], v, torch.logical_and(murty, v))
        toggle = torch.logical_and(toggle, active_cols[None, :])
        f_set = torch.logical_xor(f_set, toggle)

        x = _solve(ct_c, ct_a, f_set)
        # y only means something on G; zero it on F for the infeasibility test
        y = torch.where(f_set, 0.0, ct_c @ x - ct_a)
        it += 1
    return torch.clamp(x, min=0.0)
