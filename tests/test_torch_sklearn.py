"""tpunmf_torch's sklearn estimator against tpunmf's, on the CPU at float64.

``fit_transform``, ``transform``, ``inverse_transform``, ``n_iter_`` and
``reconstruction_err_`` for 'mu', 'cd', 'anls', KL and IS from NNDSVD
inits (the draws of a random init differ between jax.random and torch),
the validation errors, and the device rule (a CPU tensor stays on the CPU).
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from _torch_parity import TRACE_RTOL, t
from tpunmf.sklearn_api import NMF as JNMF
from tpunmf_torch.sklearn_api import NMF as TNMF

_RNG = np.random.default_rng(21)
_X = _RNG.random((50, 5)) @ _RNG.random((5, 30)) + 0.01
_NEW = _RNG.random((7, 5)) @ _RNG.random((5, 30)) + 0.01


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


@pytest.mark.parametrize("init", ["nndsvd", "nndsvda"])
@pytest.mark.parametrize("solver,loss", [
    ("mu", "frobenius"), ("cd", "frobenius"), ("anls", "frobenius"),
    ("mu", "kullback-leibler"), ("mur", "itakura-saito"),
], ids=["mu", "cd", "anls", "kl", "is"])
def test_estimator_matches_tpunmf(solver, loss, init):
    kw = dict(n_components=4, solver=solver, beta_loss=loss, init=init, max_iter=30,
              tol=1e-12)
    je, te = JNMF(**kw), TNMF(**kw)
    want = _quiet(je.fit_transform, _X)
    got = _quiet(te.fit_transform, t(_X))
    assert isinstance(got, np.ndarray) and isinstance(te.components_, np.ndarray)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(te.components_, np.asarray(je.components_), rtol=1e-8,
                               atol=1e-12)
    assert te.n_iter_ == je.n_iter_
    np.testing.assert_allclose(te.reconstruction_err_, je.reconstruction_err_,
                               rtol=TRACE_RTOL)
    enc = te.transform(t(_NEW))
    assert isinstance(enc, np.ndarray) and enc.shape == (7, 4)
    np.testing.assert_allclose(enc, np.asarray(je.transform(_NEW)), rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(te.inverse_transform(enc),
                               np.asarray(je.inverse_transform(enc)), rtol=1e-12)


def test_fit_returns_self_and_keeps_the_cpu():
    est = TNMF(n_components=3, solver="cd", init="nndsvd", max_iter=10)
    assert _quiet(est.fit, t(_X)) is est
    assert est.components_.shape == (3, 30) and est.n_iter_ >= 1
    # a float32 CPU tensor stays on the CPU and keeps its type
    est32 = TNMF(n_components=3, solver="mu", init="nndsvd", max_iter=10)
    w = _quiet(est32.fit_transform, t(_X).float())
    assert w.dtype == np.float32 and est32.transform(t(_NEW).float()).dtype == np.float32
    # random init: random_state is the solvers' int seed
    a = TNMF(n_components=3, max_iter=5, random_state=7)
    b = TNMF(n_components=3, max_iter=5, random_state=7)
    np.testing.assert_array_equal(_quiet(a.fit_transform, t(_X)),
                                  _quiet(b.fit_transform, t(_X)))


@pytest.mark.parametrize("make,exc", [
    (lambda: TNMF(n_components=3, solver="nope"), ValueError),
    (lambda: TNMF(n_components=3, init="bogus").fit(t(_X)), ValueError),
    (lambda: TNMF(n_components=3, solver="anls",
                  beta_loss="kullback-leibler").fit(t(_X)), ValueError),
    (lambda: TNMF(n_components=3, solver="cd", beta_loss="itakura-saito").fit(t(_X)),
     ValueError),
    (lambda: TNMF(n_components=3, beta_loss="hinge").fit(t(_X)), ValueError),
    (lambda: TNMF(n_components=3).transform(t(_NEW)), RuntimeError),
    (lambda: TNMF(n_components=3).inverse_transform(np.ones((2, 3))), RuntimeError),
], ids=["solver", "init", "kl_solver", "is_solver", "loss", "transform", "inverse"])
def test_validation(make, exc):
    with pytest.raises(exc):
        make()


def test_numpy_input_goes_to_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy input runs there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        TNMF(n_components=3, max_iter=2).fit(_X)
