"""tpunmf_torch's beta-divergence MUR against tpunmf's, on the CPU at float64.

``mur_beta`` from explicit inits and from NNDSVD 'zero' (nudged below
beta 1) for beta in {0, 0.5, 1, 1.5, 2, 3}; the objective itself; the
explicit-init check; the facade's ``beta=`` routing and its mutual
exclusion with ``mask=``.
"""
import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import TRACE_RTOL, assert_traces_match, lowrank, t
from tpunmf.solvers import beta_divergence as jbeta_divergence
from tpunmf.solvers import mur_beta as jmur_beta
from tpunmf_torch.solvers import beta_divergence as tbeta_divergence_export
from tpunmf_torch.solvers import mur_beta as tmur_beta
from tpunmf_torch.solvers.beta import beta_divergence as tbeta_divergence

_RNG = np.random.default_rng(11)
_X = lowrank() + 0.05
_X[::9, ::7] = 0.0  # data zeros: masked in the objective
_W0, _H0 = _RNG.random((60, 5)) + 0.1, _RNG.random((5, 48)) + 0.1
BETAS = [0.0, 0.5, 1.0, 1.5, 2.0, 3.0]


@pytest.mark.parametrize("init", ["explicit", "nndsvd_zero"])
@pytest.mark.parametrize("beta", BETAS)
def test_mur_beta_matches_tpunmf(beta, init):
    kw = dict(beta=beta, min_iter=25, max_iter=25, tol1=0.0, tol2=0.0,
              lambda_w=0.01, lambda_h=0.02)
    if init == "explicit":
        kw.update(w_init=_W0, h_init=_H0)
    else:
        kw.update(nndsvd_init=(True, "zero"))
    want = jmur_beta(_X, 5, **kw)
    got = tmur_beta(t(_X), 5, **kw)
    assert got.i == want.i == 24
    assert_traces_match(got.obj_history, want.obj_history, rtol=TRACE_RTOL)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=1e-8, atol=1e-14)
    assert got.experiment == tuple(want.experiment)
    if init == "nndsvd_zero" and beta < 1.0:
        assert got.w.min() > 0 and got.h.min() > 0  # the 1e-6 nudge


def test_convergent_run_stops_at_tpunmf_s_iteration():
    kw = dict(beta=0.5, min_iter=5, max_iter=500, tol1=3e-2, tol2=3e-2,
              w_init=_W0, h_init=_H0)
    want = jmur_beta(_X, 5, **kw)
    got = tmur_beta(t(_X), 5, **kw)
    assert got.i == want.i < 499
    assert_traces_match(got.obj_history, want.obj_history, rtol=TRACE_RTOL)


@pytest.mark.parametrize("beta", BETAS + [2.5])
def test_beta_divergence_matches_tpunmf(beta):
    wh = _W0 @ _H0
    want = float(jbeta_divergence(_X, wh, beta))
    got = float(tbeta_divergence(t(_X), t(wh), beta))
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_beta_divergence_is_exported_as_in_tpunmf():
    assert tbeta_divergence_export is tbeta_divergence
    np.testing.assert_allclose(float(tbeta_divergence_export(t(_X), t(_W0 @ _H0), 0.5)),
                               float(jbeta_divergence(_X, _W0 @ _H0, 0.5)), rtol=1e-13)


def test_explicit_init_rejection_and_negative_data():
    w0 = _W0.copy()
    w0[0, :] = 0.0  # (w0 @ h0)[0, :] == 0
    with pytest.raises(ValueError, match="strictly positive"):
        tmur_beta(t(_X), 5, beta=0.5, w_init=w0, h_init=_H0, max_iter=2)
    with pytest.raises(ValueError, match="both w_init and h_init"):
        tmur_beta(t(_X), 5, beta=0.5, w_init=_W0)
    # beta >= 1 takes the same init; negative data is shifted as tpunmf does
    kw = dict(beta=1.5, w_init=w0, h_init=_H0, min_iter=4, max_iter=4, tol1=0.0,
              tol2=0.0)
    want = jmur_beta(_X - 0.3, 5, **kw)
    got = tmur_beta(t(_X - 0.3), 5, **kw)
    assert_traces_match(got.obj_history, want.obj_history, rtol=TRACE_RTOL)


@pytest.mark.parametrize("beta,tag", [(0.0, "is"), (0.5, "beta0.5"), (1, "kl"),
                                      (2.0, "eu")])
def test_facade_routes_beta(beta, tag, tmp_path):
    kw = dict(beta=beta, min_iter=6, max_iter=6, tol1=0.0, tol2=0.0,
              nndsvd_init=(True, "zero"))
    jm = tpunmf.NMF(_X, 5)
    jm.factorize(method="mur", **kw)
    tm = tpunmf_torch.NMF(t(_X), 5)
    res = tm.factorize(method="mur", **kw)
    assert res.experiment.distance_type == tag
    assert tm.default_save_name() == jm.default_save_name()
    assert_traces_match(res.obj_history, jm.results.obj_history, rtol=TRACE_RTOL)
    # a beta fit encodes new columns by the exact EU NNLS, as tpunmf's facade
    got = tm.transform(t(_X[:, :7]))
    want = jm.transform(_X[:, :7])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=1e-12)
    path = tm.save_factorization(save_dir=str(tmp_path))
    assert tpunmf_torch.NMF.load_factorization(path).results.experiment.distance_type == tag


def test_facade_beta_excludes_mask_and_schedule():
    model = tpunmf_torch.NMF(t(_X), 5)
    with pytest.raises(ValueError, match="beta and mask are mutually exclusive"):
        model.factorize(method="mur", beta=0.5, mask=np.ones_like(_X))
    with pytest.raises(ValueError, match="schedule and beta are mutually exclusive"):
        model.factorize(method="mur", beta=0.5, schedule="auto")
    with pytest.raises(TypeError):  # beta= is MUR's: the other solvers take no beta
        model.factorize(method="hals", beta=0.5, max_iter=2)
    with pytest.raises(TypeError):
        tpunmf.NMF(_X, 5).factorize(method="hals", beta=0.5, max_iter=2)


def test_mur_beta_keeps_a_tensor_on_its_device_and_dtype():
    res = tmur_beta(t(_X).float(), 5, beta=0.5, max_iter=3, w_init=_W0, h_init=_H0)
    assert res.w.dtype == np.float32 and np.all(np.isfinite(res.obj_history))
    assert torch.from_numpy(res.h).device.type == "cpu"
