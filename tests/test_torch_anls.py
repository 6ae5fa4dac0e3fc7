"""tpunmf_torch's ANLS slice against tpunmf's, on the CPU at float64.

``solvers/anls``, ``solvers/transform`` and the facade's sklearn-style
members get the same numpy inputs as tpunmf's.  Each half-step solves its
NNLS exactly, so the trajectories are tpunmf's iterate for iterate: traces
within 1e-10, the same ``i``, factors within 1e-9 (the same exchanges with
sums in another order).
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import assert_traces_match, lowrank, t
from tpunmf.solvers import anls as janls
from tpunmf.solvers import inverse_transform as jinverse_transform
from tpunmf.solvers import transform as jtransform
from tpunmf_torch.nnls import trips
from tpunmf_torch.solvers import anls as tanls
from tpunmf_torch.solvers import inverse_transform, transform

# the module (the package's ``anls`` is the function)
ANLS = importlib.import_module("tpunmf_torch.solvers.anls")

RTOL, ATOL = 1e-9, 1e-12
_FIXED = dict(min_iter=15, max_iter=15, tol1=1e-10, tol2=1e-10)
_INIT = np.random.default_rng(7)
_W0, _H0 = _INIT.random((60, 5)), _INIT.random((5, 48))

CASES = {
    "eu": dict(),
    "kl": dict(distance_type="kl"),
    "eu_lambdas_fcnnls": dict(lambda_w=0.05, lambda_h=0.02, use_fcnnls=True),
    "eu_bpp": dict(nnls_solver="bpp"),
    "kl_bpp_cg": dict(distance_type="kl", nnls_solver="bpp", masked_solver="cg"),
    "eu_cg": dict(masked_solver="cg"),
    "eu_cg_opts": dict(masked_solver="cg", lambda_h=0.01,
                       nnls_opts=dict(cg_iters=8, opt_tol_ulps=1000.0, max_outer=16)),
    "kl_opts_chol": dict(distance_type="kl",
                         nnls_opts=dict(freeze_stalled=False, inner_cap=4)),
    "eu_explicit_init": dict(w_init=_W0, h_init=_H0),
}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    return janls(lowrank(), 5, **{**_FIXED, **CASES[name]})


def _init(kw):
    return {k: t(v) if k in ("w_init", "h_init") else v for k, v in kw.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_anls_matches_tpunmf(name):
    want = _jax_run(name)
    blocks = []
    got = tanls(t(lowrank()), 5, block_size=4, on_block_end=lambda c: blocks.append(c.i),
                **_init({**_FIXED, **CASES[name]}))
    assert blocks == [4, 8, 12, 15]
    assert got.i == want.i == 14
    assert_traces_match(got.obj_history, want.obj_history)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=RTOL, atol=ATOL)
    assert got.w.dtype == np.float64 and got.w.min() >= 0 and got.h.min() >= 0
    assert got.experiment == want.experiment


@pytest.mark.parametrize("kw", [dict(tol1=1e-3, tol2=1e-3),
                                dict(distance_type="kl", nnls_solver="bpp", tol1=1e-4,
                                     tol2=1e-4)])
def test_convergent_run_stops_at_tpunmf_s_iteration(kw):
    kw = dict(min_iter=5, max_iter=200, **kw)
    want = janls(lowrank(), 5, **kw)
    got = tanls(t(lowrank()), 5, device_loop=False, **kw)
    assert got.i == want.i < 199
    assert_traces_match(got.obj_history, want.obj_history)


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_routes_differ_only_in_the_objective(monkeypatch, dist):
    """use_pallas picks the objective wrapper (on the CPU it runs its plain
    version) for float32 X; the factors are the plain route's bit for
    bit, and nothing else of the step changes."""
    calls = []
    for name in ("eu_residual_obj", "kl_obj"):
        fn = getattr(ANLS, name)
        monkeypatch.setattr(ANLS, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    x = t(lowrank()).float()
    kw = dict(distance_type=dist, min_iter=6, max_iter=6, tol1=0.0, tol2=0.0)
    kern = tanls(x, 5, use_pallas=True, **kw)
    assert calls == [{"eu": "eu_residual_obj", "kl": "kl_obj"}[dist]] * 6
    plain = tanls(x, 5, use_pallas=False, **kw)
    assert len(calls) == 6
    np.testing.assert_array_equal(kern.w, plain.w)
    np.testing.assert_array_equal(kern.h, plain.h)
    np.testing.assert_array_equal(kern.obj_history, plain.obj_history)
    # float64 X never takes the kernels' wrappers
    tanls(t(lowrank()), 5, use_pallas=True, **kw)
    assert len(calls) == 6


def test_trips_are_counted_per_half_step_and_kept_out_of_results():
    trips.reset()
    res = tanls(t(lowrank()), 5, min_iter=4, max_iter=4, tol1=0.0, tol2=0.0)
    assert trips.calls == 8 and trips.outer >= 8 and trips.bpp == 0
    assert set(res._fields) == {"w", "h", "i", "obj_history", "experiment"}


def test_random_init_is_uniform_and_seeded():
    kw = dict(nndsvd_init=(False, "zero"), min_iter=3, max_iter=3, key=3)
    a, b = tanls(t(lowrank()), 5, **kw), tanls(t(lowrank()), 5, **kw)
    np.testing.assert_array_equal(a.w, b.w)
    assert a.experiment.nndsvd_init == (False, "zero")
    assert np.all(np.isfinite(a.obj_history))
    assert a.obj_history[-1] < a.obj_history[0]


@pytest.mark.parametrize("kw,exc,as_tpunmf", [
    (dict(nnls_solver="bpp", nnls_opts=dict(max_outer=4)), ValueError, True),
    (dict(nnls_solver="lawson"), ValueError, True),
    (dict(masked_solver="lu"), ValueError, True),
    (dict(distance_type="is"), KeyError, True),
    (dict(w_init=np.ones((60, 5))), ValueError, True),
    (dict(h_init=np.ones((5, 48))), ValueError, True),
    (dict(nnls_opts=dict(unknown=1)), TypeError, True),
    # the port's own: a checkpoint of another NNLS configuration is refused,
    # and there is no bf16 matmul precision
    (dict(checkpoint_path="ckpt"), ValueError, False),
    (dict(nnls_opts=dict(precision="bfloat16")), ValueError, False),
])
def test_anls_errors(kw, exc, as_tpunmf, tmp_path):
    if "checkpoint_path" in kw:
        kw = dict(checkpoint_path=str(tmp_path / "ckpt"), resume=True)
        tanls(t(lowrank()), 5, max_iter=2, nnls_solver="bpp", **kw)
    with pytest.raises(exc):
        tanls(t(lowrank()), 5, max_iter=2, **kw)
    if as_tpunmf:
        with pytest.raises(exc):
            janls(lowrank(), 5, max_iter=2, **kw)


def test_bfloat16_x_raises_as_in_tpunmf():
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tanls(t(lowrank()).bfloat16(), 5, max_iter=2)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        janls(np.asarray(lowrank(), dtype="bfloat16"), 5, max_iter=2)


def _basis(seed=11, m=40, n=30, k=5):
    rng = np.random.default_rng(seed)
    w = rng.random((m, k)) + 0.05
    return w, w @ rng.random((k, n)) + 0.01 * rng.random((m, n))


@pytest.mark.parametrize("kw", [dict(), dict(lambda_h=0.1),
                                dict(nnls_opts=dict(solve_method="cg")),
                                dict(distance_type="kl"),
                                dict(distance_type="kl", lambda_h=0.1, n_iter=7),
                                dict(distance_type="kl", tol=1e-3)])
def test_transform_matches_tpunmf(kw):
    w, x = _basis()
    got = transform(w, t(x), **kw)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    want = np.asarray(jtransform(w, x, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert got.min() >= 0
    np.testing.assert_allclose(inverse_transform(w, got).numpy(),
                               np.asarray(jinverse_transform(w, want)), rtol=RTOL, atol=ATOL)


def test_transform_follows_x_new_s_device_and_w_s_dtype():
    w, x = _basis()
    # a numpy W meets a CPU tensor: the CPU, in W's dtype
    got = transform(w.astype(np.float32), t(x))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    # numpy X_new asks for the card, and without one raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPU torch.Tensor"):
            transform(t(w), x)
    with pytest.raises(ValueError):
        transform(t(w), t(x[:-1]))
    with pytest.raises(KeyError):
        transform(t(w), t(x), distance_type="nope")


def _fitted(pkg, data, **kw):
    model = pkg.NMF(data, 5)
    model.factorize(method="anls", min_iter=10, max_iter=10, tol1=0.0, tol2=0.0, **kw)
    return model


@pytest.mark.parametrize("dist", ["eu", "kl"])
def test_facade_members_match_tpunmf(dist):
    ours = _fitted(tpunmf_torch, t(lowrank()), distance_type=dist)
    theirs = _fitted(tpunmf, lowrank(), distance_type=dist)
    np.testing.assert_allclose(ours.components_, np.asarray(theirs.components_),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.reconstruction_err_, theirs.reconstruction_err_,
                               rtol=1e-10)
    x_new = np.random.default_rng(1).random((60, 7))
    got = ours.transform(t(x_new))          # the trained distance by default
    want = np.asarray(theirs.transform(x_new))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.inverse_transform(got).numpy(),
                               np.asarray(theirs.inverse_transform(want)),
                               rtol=RTOL, atol=ATOL)
    if dist == "eu":
        # encoding the training data fits at least as well as the fit
        h_in = ours.transform(t(lowrank())).numpy()
        fit = np.linalg.norm(lowrank() - ours.w @ ours.h)
        assert np.linalg.norm(lowrank() - ours.w @ h_in) <= fit * (1 + 1e-6)


def test_fit_fit_transform_and_untrained_guards(tmp_path):
    model = tpunmf_torch.NMF(t(lowrank()), 4).fit(method="anls", min_iter=2, max_iter=5,
                                                 tol1=0.0, tol2=0.0)
    assert isinstance(model, tpunmf_torch.NMF) and model.w.shape == (60, 4)
    w = tpunmf_torch.NMF(t(lowrank()), 4).fit_transform(method="hals", min_iter=2,
                                                        max_iter=5, tol1=0.0, tol2=0.0)
    assert np.asarray(w).shape == (60, 4)
    empty = tpunmf_torch.NMF(t(lowrank()), 3)
    assert empty.components_ is None and empty.reconstruction_err_ is None
    with pytest.raises(RuntimeError):
        empty.transform(t(lowrank()))
    with pytest.raises(RuntimeError):
        empty.inverse_transform(t(np.ones((3, 4))))


@pytest.mark.parametrize("fcnnls", [True, False])
def test_save_name_and_roundtrip_as_tpunmf(tmp_path, fcnnls):
    kw = dict(use_fcnnls=fcnnls, lambda_w=0.1)
    ours = _fitted(tpunmf_torch, t(lowrank()), **kw)
    theirs = _fitted(tpunmf, lowrank(), **kw)
    assert ours.default_save_name() == theirs.default_save_name()
    assert ours.default_save_name().endswith("_fcnnls") == fcnnls
    path = ours.save_factorization(save_dir=str(tmp_path))
    back = tpunmf_torch.NMF.load_factorization(path)
    assert back.default_save_name() == ours.default_save_name()
    np.testing.assert_array_equal(back.w, ours.w)
    # a loaded model encodes new data like the one it was saved from
    np.testing.assert_array_equal(back.transform(t(lowrank())).numpy(),
                                  ours.transform(t(lowrank())).numpy())
