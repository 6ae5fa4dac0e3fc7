"""tpunmf_torch's robust (l2,1) NMF against tpunmf's, on the CPU at float64.

From NNDSVD 'zero' (nudged to 1e-6, the default) and from explicit inits,
at two shapes, on X with a few columns corrupted by outliers
(tests/test_robust.py's recipe); the column residual norms against the
explicit l2,1 norm; the negative-X error; the facade; checkpoints across
the packages.
"""
import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import assert_results_match, run_interrupted, t
from tpunmf.solvers import robust_nmf as jrobust_nmf
from tpunmf_torch.solvers import robust_nmf
from tpunmf_torch.solvers.robust import _column_residual_norms

# factors of the two packages at f64: the same formulas, sums in another order
FACTOR_RTOL = 1e-9
_KW = dict(min_iter=30, max_iter=30, tol1=0.0, tol2=0.0)


def _corrupted(m, n, k=4, n_out=4, seed=0):
    """tests/test_robust.py's _lowrank_with_outliers."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((m, k))) @ np.abs(rng.standard_normal((k, n)))
    out_cols = rng.choice(n, size=n_out, replace=False)
    x[:, out_cols] += 50.0 * np.abs(rng.standard_normal((m, n_out)))
    return x


@pytest.mark.parametrize("shape", [(60, 80), (80, 256)])
@pytest.mark.parametrize("init", ["nndsvd_zero", "explicit"])
def test_robust_nmf_matches_tpunmf(shape, init):
    x = _corrupted(*shape)
    kw = dict(_KW)
    if init == "explicit":
        rng = np.random.default_rng(1)
        kw.update(w_init=np.abs(rng.standard_normal((shape[0], 4))),
                  h_init=np.abs(rng.standard_normal((4, shape[1]))))
    want = jrobust_nmf(x, 4, **kw)
    got = robust_nmf(t(x), 4, **kw)
    assert got.i == 29
    assert_results_match(got, want, FACTOR_RTOL)
    if init == "nndsvd_zero":
        assert got.w.min() > 0 and got.h.min() > 0  # the 1e-6 nudge
    hist = np.asarray(got.obj_history)
    assert np.all(np.diff(hist) <= 1e-6 * np.abs(hist[:-1]))  # monotone l2,1


def test_column_norms_are_the_l21_norm():
    x = _corrupted(60, 80)
    rng = np.random.default_rng(2)
    w, h = rng.random((60, 4)), rng.random((4, 80))
    xt, wt, ht = t(x), t(w), t(h)
    got = _column_residual_norms(torch.sum(xt * xt, dim=0), wt.T @ xt, wt.T @ wt, ht)
    np.testing.assert_allclose(got.numpy(), np.linalg.norm(x - w @ h, axis=0), rtol=1e-10)


def test_negative_x_is_refused_as_tpunmf_refuses_it():
    x = _corrupted(60, 80)
    x[3, 7] = -1e-3
    with pytest.raises(ValueError, match="x must be non-negative"):
        robust_nmf(t(x), 4)
    with pytest.raises(ValueError, match="x must be non-negative"):
        jrobust_nmf(x, 4)
    with pytest.raises(ValueError, match="provide both w_init and h_init"):
        robust_nmf(t(np.abs(x)), 4, w_init=np.ones((60, 4)))


def test_facade_routes_robust(tmp_path):
    x = _corrupted(60, 80)
    want = tpunmf.NMF(x, 4).factorize(method="robust", **_KW)
    model = tpunmf_torch.NMF(t(x), 4)
    assert_results_match(model.factorize(method="robust", **_KW), want, FACTOR_RTOL)
    assert model.default_save_name() == "nmf_robust_4_l21_0.0_0.0_nndsvdz"


@pytest.mark.parametrize("direction", ["tpunmf_to_port", "port_to_tpunmf"])
def test_checkpoint_crosses_between_packages(tmp_path, direction):
    x = _corrupted(60, 80)
    want = jrobust_nmf(x, 4, **_KW)
    writer, reader = ((jrobust_nmf, robust_nmf) if direction == "tpunmf_to_port"
                      else (robust_nmf, jrobust_nmf))
    data = {jrobust_nmf: x, robust_nmf: t(x)}
    ck = str(tmp_path / "robust")
    run_interrupted(lambda **c: writer(data[writer], 4, **_KW, **c), ck, 10, 2)
    got = reader(data[reader], 4, checkpoint_path=ck, checkpoint_every=10, resume=True,
                 **_KW)
    assert_results_match(got, want, FACTOR_RTOL)
