"""tpunmf_torch's semi-NMF against tpunmf's, on the CPU at float64.

Mixed-sign X (column-centred), from explicit inits (torch cannot draw
jax.random's numbers): H alone (W from the least-squares init) or both,
with and without ``lambda_h``, at two shapes; the least-squares init on
full-rank, near-degenerate and rank-deficient H against
``jnp.linalg.lstsq``; no elevation of X; the facade; checkpoints across
the packages; the init errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tpunmf
import tpunmf_torch
from _torch_parity import assert_results_match, lowrank, run_interrupted, t
from tpunmf.solvers import semi_nmf as jsemi_nmf
from tpunmf_torch.solvers import semi_nmf
from tpunmf_torch.solvers.semi import _lstsq

# factors of the two packages at f64: the same formulas, sums in another order
FACTOR_RTOL = 1e-9


def _problem(m, n, seed=3):
    x = lowrank(m=m, n=n)
    x = x - x.mean(axis=0)  # centred: mixed sign
    rng = np.random.default_rng(seed)
    return x, rng.standard_normal((m, 5)), np.abs(rng.standard_normal((5, n)))


_KW = dict(min_iter=30, max_iter=30, tol1=0.0, tol2=0.0)


@pytest.mark.parametrize("shape", [(60, 48), (80, 256)])
@pytest.mark.parametrize("lambda_h", [0.0, 0.1])
@pytest.mark.parametrize("init", ["h", "w_and_h"])
def test_semi_nmf_matches_tpunmf(shape, lambda_h, init):
    x, w0, h0 = _problem(*shape)
    assert x.min() < 0 < x.max()
    kw = dict(_KW, lambda_h=lambda_h, h_init=h0)
    if init == "w_and_h":
        kw["w_init"] = w0
    want = jsemi_nmf(x, 5, **kw)
    got = semi_nmf(t(x), 5, **kw)
    assert got.i == 29
    assert_results_match(got, want, FACTOR_RTOL)
    assert got.w.min() < 0  # W is free-sign


@pytest.mark.parametrize("kind", ["full_rank", "near_degenerate", "rank_deficient"])
def test_least_squares_init_is_lstsq_s(kind):
    x, _, h = _problem(60, 48)
    if kind == "near_degenerate":
        # row 1 an ulp or so off row 0: a singular value far below the cut
        h[1] = h[0] * (1.0 + 2.2e-16 * (-1.0) ** np.arange(48))
        assert not np.array_equal(h[1], h[0])
    elif kind == "rank_deficient":
        h[1] = h[0]
    want = np.asarray(jnp.linalg.lstsq(h.T, x.T)[0].T)
    got = _lstsq(t(h).T, t(x).T).T.numpy()
    np.testing.assert_allclose(got, want, rtol=FACTOR_RTOL,
                               atol=FACTOR_RTOL * np.abs(want).max())
    if kind != "full_rank":
        # the minimum-norm answer splits the weight of the two rows evenly
        np.testing.assert_allclose(got[:, 0], got[:, 1], rtol=1e-6)


def test_mixed_sign_x_is_not_elevated():
    x, w0, h0 = _problem(60, 48)
    res = semi_nmf(t(x), 5, w_init=w0, h_init=h0, min_iter=1, max_iter=1)
    d = x - w0 @ h0
    np.testing.assert_allclose(res.obj_history[0], 0.5 * np.sum(d * d), rtol=1e-12)


def test_facade_routes_semi_nmf(tmp_path):
    x, _, h0 = _problem(60, 48)
    want = tpunmf.NMF(x, 5).factorize(method="semi_nmf", h_init=h0, **_KW)
    model = tpunmf_torch.NMF(t(x), 5)
    got = model.factorize(method="semi_nmf", h_init=h0, **_KW)
    assert_results_match(got, want, FACTOR_RTOL)
    path = model.save_factorization(save_dir=str(tmp_path))
    assert path.endswith("nmf_semi_nmf_5_eu_0.0_0.0_random.npz")
    back = tpunmf_torch.NMF.load_factorization(path)
    np.testing.assert_array_equal(back.w, model.w)
    np.testing.assert_array_equal(back.results.obj_history, model.results.obj_history)


@pytest.mark.parametrize("direction", ["tpunmf_to_port", "port_to_tpunmf"])
def test_checkpoint_crosses_between_packages(tmp_path, direction):
    x, _, h0 = _problem(60, 48)
    kw = dict(_KW, h_init=h0)
    want = jsemi_nmf(x, 5, **kw)
    writer, reader = ((jsemi_nmf, semi_nmf) if direction == "tpunmf_to_port"
                      else (semi_nmf, jsemi_nmf))
    data = {jsemi_nmf: x, semi_nmf: t(x)}
    ck = str(tmp_path / "semi")
    run_interrupted(lambda **c: writer(data[writer], 5, **kw, **c), ck, 10, 2)
    got = reader(data[reader], 5, checkpoint_path=ck, checkpoint_every=10, resume=True,
                 **kw)
    assert_results_match(got, want, FACTOR_RTOL)


def test_init_errors_are_tpunmf_s():
    x, w0, _ = _problem(60, 48)
    with pytest.raises(ValueError, match="pass h_init when passing w_init"):
        semi_nmf(t(x), 5, w_init=w0)
    with pytest.raises(ValueError, match="pass h_init when passing w_init"):
        jsemi_nmf(x, 5, w_init=w0)
