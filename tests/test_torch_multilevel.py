"""tpunmf_torch's multilevel NMF against tpunmf's, on the CPU at float64.

The warm start over HALS and MUR (EU and KL), coarsening columns
(``axis=1``) and rows (``axis=0``, with ``lambda_w`` and ``lambda_h``
swapped), at two shapes; the restriction and prolongation on a ragged
width; the facade's ``multilevel=`` for mur and hals and its errors.  MUR's
coarsest level starts from NNDSVD 'zero' (torch cannot draw jax.random's
numbers).
"""
import numpy as np
import pytest

import tpunmf
import tpunmf_torch
from _torch_parity import assert_results_match, lowrank, t
from tpunmf.solvers import multilevel as jmultilevel
from tpunmf.solvers.multilevel import coarsen_columns as jcoarsen_columns
from tpunmf.solvers.multilevel import prolongate_h as jprolongate_h
from tpunmf_torch.solvers import multilevel, mur_multilevel
from tpunmf_torch.solvers.multilevel import coarsen_columns, prolongate_h

# factors of the two packages at f64: the same formulas, sums in another order
FACTOR_RTOL = 1e-9
_KW = dict(min_iter=30, max_iter=30, tol1=0.0, tol2=0.0, coarse_iters=25)
_RUNS = {
    "hals": dict(method="hals"),
    "hals_lambda": dict(method="hals", lambda_w=0.1),
    "mur_eu": dict(method="mur", distance_type="eu", nndsvd_init=(True, "zero")),
    "mur_kl_lambda": dict(method="mur", distance_type="kl", nndsvd_init=(True, "zero"),
                          lambda_w=0.05, lambda_h=0.02),
}


@pytest.mark.parametrize("run,axis,shape", [
    ("hals", 1, (60, 48)), ("hals", 0, (80, 256)), ("hals_lambda", 0, (60, 48)),
    ("mur_eu", 1, (80, 256)), ("mur_eu", 0, (60, 48)), ("mur_kl_lambda", 1, (60, 48)),
    ("mur_kl_lambda", 0, (80, 256))])
def test_multilevel_matches_tpunmf(run, axis, shape):
    x = lowrank(m=shape[0], n=shape[1])
    kw = dict(_KW, axis=axis, **_RUNS[run])
    want = jmultilevel(x, 5, **kw)
    got = multilevel(t(x), 5, **kw)
    assert got.i == 29 and got.w.shape == (shape[0], 5) and got.h.shape == (5, shape[1])
    assert_results_match(got, want, FACTOR_RTOL)


def test_axis_0_swaps_a_lone_lambda_w():
    """With axis=0 a lone lambda_w becomes the mirror problem's lambda_h:
    the result is the mirror's with lambda_h, transposed back."""
    x = lowrank()
    kw = dict(_KW, method="hals")
    got = multilevel(t(x), 5, axis=0, lambda_w=0.3, **kw)
    mirror = multilevel(t(x.T.copy()), 5, lambda_h=0.3, **kw)
    np.testing.assert_array_equal(got.w, mirror.h.T)
    np.testing.assert_array_equal(got.obj_history, mirror.obj_history)
    assert got.experiment.lambda_h == 0.3 and got.experiment.lambda_w == 0.0


def test_restriction_and_prolongation_are_tpunmf_s():
    x = lowrank(m=30, n=50)  # 50 = 12 groups of 4 and a ragged 2
    got = coarsen_columns(t(x), 4)
    want = np.asarray(jcoarsen_columns(x, 4))
    assert got.shape == (30, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    h_c = np.random.default_rng(0).random((5, 13))
    np.testing.assert_array_equal(prolongate_h(t(h_c), 4, 50).numpy(),
                                  np.asarray(jprolongate_h(h_c, 4, 50)))


@pytest.mark.parametrize("method", ["mur", "hals"])
def test_facade_multilevel_is_tpunmf_s(method):
    x = lowrank()
    ml = {"levels": 1, "factor": 2, "coarse_iters": 10}
    kw = dict(min_iter=12, max_iter=12, tol1=0.0, tol2=0.0, nndsvd_init=(True, "zero"))
    want = tpunmf.NMF(x, 5).factorize(method=method, multilevel=ml, **kw)
    got = tpunmf_torch.NMF(t(x), 5).factorize(method=method, multilevel=ml, **kw)
    assert_results_match(got, want, FACTOR_RTOL)
    if method == "mur":
        assert_results_match(mur_multilevel(t(x), 5, **ml, **kw), want, FACTOR_RTOL)


def test_errors_are_tpunmf_s():
    x = lowrank()
    for nmf, data in ((tpunmf_torch.NMF, t(x)), (tpunmf.NMF, x)):
        with pytest.raises(ValueError, match="supports methods mur and hals"):
            nmf(data, 5).factorize(method="anls", multilevel=True)
        with pytest.raises(ValueError, match="supports methods mur and hals"):
            nmf(data, 5).factorize(method="ntf", multilevel=True)
        with pytest.raises(ValueError, match="levels must be >= 1"):
            nmf(data, 5).factorize(method="hals", multilevel={"levels": 0})
        with pytest.raises(ValueError, match="factor must be >= 2"):
            nmf(data, 5).factorize(method="hals", multilevel={"factor": 1})
    with pytest.raises(KeyError, match="multilevel supports"):
        multilevel(t(x), 5, method="anls")


def test_checkpoint_resume_is_refused_as_in_tpunmf(tmp_path):
    """checkpoint_path goes to every level's solve, as in tpunmf, so with
    resume=True the fine solve meets the coarse level's file: both
    packages refuse it the same way."""
    kw = dict(method="hals", min_iter=10, max_iter=10, coarse_iters=10, resume=True)
    x = lowrank()
    messages = []
    for fn, data, name in ((jmultilevel, x, "tpunmf"), (multilevel, t(x), "port")):
        with pytest.raises(ValueError, match="configuration mismatch") as err:
            fn(data, 5, checkpoint_path=str(tmp_path / name), **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
