"""tpunmf_torch's orthogonal NMF against tpunmf's, on the CPU at float64.

``orthogonal="h"`` and ``"w"`` (the mirror problem on a copy of X^T), from
NNDSVD 'zero' (nudged to 1e-6) and from explicit inits, at two shapes; X
shifted by -min(X); the orthogonality residual; the facade with a
save/load round trip; checkpoints across the packages; the errors.
"""
import numpy as np
import pytest

import tpunmf
import tpunmf_torch
from _torch_parity import assert_results_match, lowrank, run_interrupted, t
from tpunmf.solvers import onmf as jonmf
from tpunmf.solvers import orthogonality_residual as jorthogonality_residual
from tpunmf_torch.solvers import onmf, orthogonality_residual

# factors of the two packages at f64: the same formulas, sums in another order
FACTOR_RTOL = 1e-9
_KW = dict(min_iter=30, max_iter=30, tol1=0.0, tol2=0.0)


def _problem(m, n, seed=5):
    rng = np.random.default_rng(seed)
    return lowrank(m=m, n=n), rng.random((m, 5)) + 0.1, rng.random((5, n)) + 0.1


@pytest.mark.parametrize("shape", [(60, 48), (80, 256)])
@pytest.mark.parametrize("init", ["nndsvd_zero", "explicit"])
@pytest.mark.parametrize("orthogonal", ["h", "w"])
def test_onmf_matches_tpunmf(shape, init, orthogonal):
    x, w0, h0 = _problem(*shape)
    kw = dict(_KW, orthogonal=orthogonal)
    if init == "explicit":
        kw.update(w_init=w0, h_init=h0)
    else:
        kw.update(nndsvd_init=(True, "zero"))
    want = jonmf(x, 5, **kw)
    got = onmf(t(x), 5, **kw)
    assert got.i == 29 and got.w.shape == (shape[0], 5) and got.h.shape == (5, shape[1])
    assert_results_match(got, want, FACTOR_RTOL)
    if init == "nndsvd_zero":
        assert got.w.min() > 0 and got.h.min() > 0  # the 1e-6 nudge
    factor = got.h if orthogonal == "h" else got.w.T
    np.testing.assert_allclose(float(orthogonality_residual(factor)),
                               float(jorthogonality_residual(factor)), rtol=1e-12)


def test_negative_x_is_shifted_as_tpunmf_shifts_it():
    x, w0, h0 = _problem(60, 48)
    kw = dict(_KW, w_init=w0, h_init=h0)
    want = jonmf(x - 0.4, 5, **kw)
    got = onmf(t(x - 0.4), 5, **kw)
    assert_results_match(got, want, FACTOR_RTOL)
    shifted = x - 0.4 - (x - 0.4).min()
    d = shifted - w0 @ h0
    np.testing.assert_allclose(got.obj_history[0], 0.5 * np.sum(d * d), rtol=1e-12)


def test_facade_routes_onmf_and_round_trips(tmp_path):
    x, _, _ = _problem(60, 48)
    kw = dict(_KW, nndsvd_init=(True, "zero"))
    want = tpunmf.NMF(x, 5).factorize(method="onmf", **kw)
    model = tpunmf_torch.NMF(t(x), 5)
    assert_results_match(model.factorize(method="onmf", **kw), want, FACTOR_RTOL)
    path = model.save_factorization(save_dir=str(tmp_path))
    assert path.endswith("nmf_onmf_5_eu-onmf_0.0_0.0_nndsvdz.npz")
    back = tpunmf.NMF.load_factorization(path)
    np.testing.assert_array_equal(back.h, model.h)
    assert back.results.experiment._asdict() == model.results.experiment._asdict()


@pytest.mark.parametrize("direction", ["tpunmf_to_port", "port_to_tpunmf"])
def test_checkpoint_crosses_between_packages(tmp_path, direction):
    x, _, _ = _problem(60, 48)
    kw = dict(_KW, nndsvd_init=(True, "zero"))
    want = jonmf(x, 5, **kw)
    writer, reader = ((jonmf, onmf) if direction == "tpunmf_to_port" else (onmf, jonmf))
    data = {jonmf: x, onmf: t(x)}
    ck = str(tmp_path / "onmf")
    run_interrupted(lambda **c: writer(data[writer], 5, **kw, **c), ck, 10, 2)
    got = reader(data[reader], 5, checkpoint_path=ck, checkpoint_every=10, resume=True,
                 **kw)
    assert_results_match(got, want, FACTOR_RTOL)


def test_errors_are_tpunmf_s():
    x, w0, _ = _problem(60, 48)
    for fn, data in ((onmf, t(x)), (jonmf, x)):
        with pytest.raises(ValueError, match="orthogonal must be 'h' or 'w'"):
            fn(data, 5, orthogonal="x")
        with pytest.raises(ValueError, match="pass both w_init and h_init"):
            fn(data, 5, w_init=w0)
