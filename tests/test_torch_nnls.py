"""tpunmf_torch's batched NNLS against tpunmf's, on the CPU at float64.

``nnls_activeset`` ('chol' and 'cg') and ``nnls_bpp``, cold and warm, get
the same numpy inputs as tpunmf's and are held to them within 1e-9 (the
same exchanges in another summation order) and to scipy's per-column
Lawson-Hanson within its 1e-6 (tests/test_nnls.py).
"""
import numpy as np
import pytest
import torch
from scipy import optimize

from _torch_parity import t
from tpunmf.core import linalg as jlinalg
from tpunmf.nnls import activeset as jactiveset
from tpunmf.nnls import masked_solve_cg as jmasked_solve_cg
from tpunmf.nnls import nnls_activeset as jnnls_activeset
from tpunmf.nnls import nnls_bpp as jnnls_bpp
from tpunmf_torch.core import linalg as tlinalg
from tpunmf_torch.nnls import activeset as tactiveset
from tpunmf_torch.nnls import (masked_solve, masked_solve_cg, nnls, nnls_activeset, nnls_bpp,
                               trips)

RTOL, ATOL = 1e-9, 1e-12


def _problem(seed=0, n_obs=40, l=10, p=25):
    """tests/test_nnls.py's mix of easy and hard columns."""
    rng = np.random.default_rng(seed)
    c = rng.random((n_obs, l))
    a = c @ rng.random((l, p)) + 0.5 * rng.standard_normal((n_obs, p))
    return c, a


def _scipy_columns(c, a):
    out = np.zeros((c.shape[1], a.shape[1]))
    for j in range(a.shape[1]):
        out[:, j], _ = optimize.nnls(c, a[:, j])
    return out


def _warm(expect, seed=5):
    """A near-solution with some support wrong: values and passive sets."""
    rng = np.random.default_rng(seed)
    near = np.maximum(expect * (1.0 + 0.3 * rng.standard_normal(expect.shape))
                      + 0.05 * rng.standard_normal(expect.shape), 0.0)
    return near > 0, near


SOLVERS = {
    "activeset_chol": (nnls_activeset, jnnls_activeset, dict(solve_method="chol")),
    "activeset_cg": (nnls_activeset, jnnls_activeset, dict(solve_method="cg")),
    "activeset_cg_loose": (nnls_activeset, jnnls_activeset,
                           dict(solve_method="cg", opt_tol_ulps=1000.0)),
    "bpp_chol": (nnls_bpp, jnnls_bpp, dict(solve_method="chol")),
    "bpp_cg": (nnls_bpp, jnnls_bpp, dict(solve_method="cg")),
}


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("name", list(SOLVERS))
def test_nnls_matches_tpunmf_and_scipy(name, start):
    ours, theirs, kw = SOLVERS[name]
    c, a = _problem()
    ct_c, ct_a = c.T @ c, c.T @ a
    expect = _scipy_columns(c, a)
    args = ()
    if start == "warm":
        p0, k0 = _warm(expect)
        args = (p0,) if ours is nnls_bpp else (p0, k0)
    want = np.asarray(theirs(ct_c, ct_a, *args, **kw))
    got = ours(t(ct_c), t(ct_a), *(t(x) for x in args), **kw)
    assert got.dtype == torch.float64 and got.shape == (10, 25)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-6, atol=1e-8)
    assert got.min() >= 0


@pytest.mark.parametrize("backup_budget", [0, 3])
def test_bpp_murty_rule_matches_tpunmf(backup_budget):
    """Correlated columns, where a full exchange can fail to shrink the
    infeasible set: with no backup budget BPP takes Murty's rule there (one
    more trip than with 3), and lands on tpunmf's answer and the active-set
    solver's."""
    rng = np.random.default_rng(0)
    c = rng.standard_normal((15, 12))
    ct_c, ct_a = c.T @ c + 1e-3 * np.eye(12), c.T @ rng.standard_normal((15, 20))
    trips.reset()
    got = nnls_bpp(t(ct_c), t(ct_a), backup_budget=backup_budget).numpy()
    assert trips.bpp == {0: 6, 3: 5}[backup_budget]
    want = np.asarray(jnnls_bpp(ct_c, ct_a, backup_budget=backup_budget))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, nnls_activeset(t(ct_c), t(ct_a)).numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("solver", [nnls_activeset, nnls_bpp])
def test_dead_component_solves_to_an_exact_zero(solver):
    """A zero column of C (an all-zero NNDSVD 'zero' factor row) gives a
    zero Gram row: its coefficient is exactly 0 and no NaN enters."""
    rng = np.random.default_rng(3)
    c = rng.random((30, 6)) + 0.05
    c[:, 2] = 0.0
    a = rng.random((30, 9))
    got = solver(t(c.T @ c), t(c.T @ a)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got[2], 0.0)
    want = np.asarray((jnnls_activeset if solver is nnls_activeset else jnnls_bpp)(
        c.T @ c, c.T @ a))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    keep = [0, 1, 3, 4, 5]
    np.testing.assert_allclose(got[keep], _scipy_columns(c[:, keep], a), atol=1e-8)


def test_masked_solves_match_tpunmf():
    rng = np.random.default_rng(1)
    l, p = 6, 12
    c = rng.random((20, l))
    ct_c = c.T @ c + 0.1 * np.eye(l)
    ct_a = rng.standard_normal((l, p))
    p_set = rng.random((l, p)) > 0.4
    got = masked_solve(t(ct_c), t(ct_a), t(p_set)).numpy()
    np.testing.assert_allclose(got, np.asarray(jactiveset.masked_solve(ct_c, ct_a, p_set)),
                               rtol=RTOL, atol=ATOL)
    assert np.all(got[~p_set] == 0.0)
    x0 = rng.random((l, p))
    for kw in (dict(), dict(iters=3), dict(iters=3, x0=x0)):
        got = masked_solve_cg(t(ct_c), t(ct_a), t(p_set),
                              **{k: t(v) if k == "x0" else v for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jmasked_solve_cg(ct_c, ct_a, p_set, **kw)), rtol=RTOL, atol=ATOL)


def test_chunked_masked_solve_matches_unchunked(monkeypatch):
    """Above the (p, l, l) budget the columns are solved in chunks, one
    after the other (the last one short): the same solutions."""
    rng = np.random.default_rng(2)
    l, p = 8, 37
    c = rng.random((30, l))
    ct_c, ct_a = t(c.T @ c + 0.1 * np.eye(l)), t(rng.standard_normal((l, p)))
    p_set = t(rng.random((l, p)) > 0.3)
    whole = masked_solve(ct_c, ct_a, p_set)
    c2, a2 = _problem(seed=4)
    direct = nnls_activeset(t(c2.T @ c2), t(c2.T @ a2))
    # 5 columns a chunk: 37 = 7 * 5 + 2
    monkeypatch.setattr(tactiveset, "_MASKED_SOLVE_BYTES_BUDGET", 5 * l * l * 8)
    chunked = masked_solve(ct_c, ct_a, p_set)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(nnls_activeset(t(c2.T @ c2), t(c2.T @ a2)).numpy(),
                               direct.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("freeze_stalled", [True, False])
def test_freeze_stalled_matches_tpunmf_and_keeps_the_optimum(freeze_stalled):
    rng = np.random.default_rng(6)
    l, p = 12, 40
    c = rng.standard_normal((30, l))
    ct_c = c.T @ c + 1e-6 * np.eye(l)
    ct_a = c.T @ rng.standard_normal((30, p))
    got = nnls_activeset(t(ct_c), t(ct_a), freeze_stalled=freeze_stalled).numpy()
    want = np.asarray(jnnls_activeset(ct_c, ct_a, freeze_stalled=freeze_stalled))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    other = nnls_activeset(t(ct_c), t(ct_a), freeze_stalled=not freeze_stalled).numpy()
    np.testing.assert_allclose(got, other, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("opts", [dict(max_outer=2), dict(inner_cap=1),
                                  dict(max_outer=3, inner_cap=2, solve_method="cg")])
def test_loop_bounds_match_tpunmf(opts):
    """Cut budgets stop the loops at tpunmf's trip: the same partial answer."""
    c, a = _problem(seed=7)
    got = nnls_activeset(t(c.T @ c), t(c.T @ a), **opts).numpy()
    want = np.asarray(jnnls_activeset(c.T @ c, c.T @ a, **opts))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_trips_are_counted_apart_from_the_results():
    c, a = _problem(seed=8)
    ct_c, ct_a = t(c.T @ c), t(c.T @ a)
    trips.reset()
    first = nnls_activeset(ct_c, ct_a)
    counted = trips.as_dict()
    assert counted["calls"] == 1 and counted["outer"] > 0 and counted["bpp"] == 0
    assert torch.equal(nnls_activeset(ct_c, ct_a), first)
    assert trips.as_dict()["outer"] == 2 * counted["outer"]
    trips.reset()
    nnls_bpp(ct_c, ct_a)
    assert trips.calls == 1 and trips.bpp > 0 and trips.outer == trips.inner == 0
    assert torch.equal(nnls(t(c), t(a)), first)


@pytest.mark.parametrize("precision", [None, "highest", "float32", "high", "tensorfloat32"])
def test_precisions_run_the_same_solve_on_the_cpu(precision):
    c, a = _problem(seed=9)
    kw = dict(solve_method="cg", precision=precision)
    got = nnls_activeset(t(c.T @ c), t(c.T @ a), **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(jnnls_activeset(c.T @ c, c.T @ a, **kw)),
                               rtol=RTOL, atol=ATOL)


def test_nnls_errors():
    ct_c, ct_a = t(np.eye(3)), t(np.ones((3, 2)))
    with pytest.raises(ValueError, match="require p_set0"):
        nnls_activeset(ct_c, ct_a, None, t(np.ones((3, 2))))
    with pytest.raises(ValueError, match="precision"):
        nnls_activeset(ct_c, ct_a, precision="bfloat16")


def test_spd_solve_of_a_singular_matrix_is_nan_as_in_tpunmf():
    """No host check: a matrix that is not positive definite gives NaN."""
    a = np.array([[1.0, 1.0], [1.0, 1.0]])
    b = np.ones((2, 3))
    want = np.asarray(jlinalg.spd_solve(a, b))
    got = tlinalg.spd_solve(t(a), t(b)).numpy()
    assert np.all(np.isnan(want)) and np.all(np.isnan(got))
