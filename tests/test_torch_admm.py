"""tpunmf_torch's ADMM slice against tpunmf's, on the CPU at float64.

``core/linalg.spd_solve``, every prox operator and ``solvers/admm`` get the
same numpy inputs as tpunmf's.  ADMM's objective is not monotone and its
stop is sensitive to rounding (benchmarks/run_configs.py:200-224), so the
traces are compared over fixed budgets (min_iter = max_iter), on both of
the port's routes; one convergent run must stop at the same ``i``.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import assert_traces_match, lowrank, t
from tpunmf.core import linalg as jlinalg
from tpunmf.data import densify as jdensify
from tpunmf.data import sparse_csr as jsparse_csr
from tpunmf.prox import operators as jprox
from tpunmf.solvers import admm as jadmm
from tpunmf_torch.core import linalg as tlinalg
from tpunmf_torch.data import densify as tdensify
from tpunmf_torch.data import sparse_csr as tsparse_csr
from tpunmf_torch.io import convert
from tpunmf_torch.ops import fused as tfused
from tpunmf_torch.prox import operators as tprox
from tpunmf_torch.solvers import admm as tadmm
from tpunmf_torch.solvers.admm import _admm_block

_FIXED = dict(min_iter=20, max_iter=20, tol1=1e-10, tol2=1e-10,
              nndsvd_init=(True, "zero"))
_INIT = np.random.default_rng(7)
_W0, _H0 = _INIT.random((60, 5)) + 0.1, _INIT.random((5, 48)) + 0.1

CASES = {
    "eu_fixed": dict(distance_type="eu"),
    "kl_fixed": dict(distance_type="kl"),
    "eu_adaptive_l1n": dict(distance_type="eu", rho_mode="adaptive", rho=10.0,
                            reg_h=(0.05, "l1n")),
    "kl_adaptive_l2n": dict(distance_type="kl", rho_mode="adaptive", rho=10.0,
                            reg_h=(0.05, "l2n")),
    "eu_l1inf": dict(distance_type="eu", rho=1.5, reg_h=(0.2, "l1inf")),
    "kl_l1n": dict(distance_type="kl", reg_h=(0.1, "l1n")),
    "eu_l2n_on_w": dict(distance_type="eu", reg_w=(0.05, "l2n"), reg_h=(0, "nn")),
    "eu_cg": dict(distance_type="eu", spd_solver="cg", reg_h=(0.05, "l1n")),
    "kl_explicit_init": dict(distance_type="kl", w_init=_W0, h_init=_H0),
}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    return jadmm(lowrank(), 5, **{**_FIXED, **CASES[name]})


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("name", list(CASES))
def test_admm_matches_tpunmf(name, use_pallas):
    want = _jax_run(name)
    rhos = []
    got = tadmm(t(lowrank()), 5, use_pallas=use_pallas, block_size=5,
                on_block_end=lambda c: rhos.append(float(c.inner[-1])),
                **{**_FIXED, **CASES[name]})
    assert got.i == want.i == 19
    assert_traces_match(got.obj_history, want.obj_history)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=1e-8, atol=1e-12)
    assert got.w.dtype == np.float64 and got.w.min() >= 0 and got.h.min() >= 0
    # adaptive damping moves rho away from its start; fixed keeps it
    rho0 = CASES[name].get("rho", 1.0)
    assert (rhos[-1] != rho0) == (CASES[name].get("rho_mode") == "adaptive")


@pytest.mark.parametrize("distance", ["eu", "kl"])
def test_convergent_run_stops_at_tpunmf_s_iteration(distance):
    kw = dict(distance_type=distance, min_iter=10, max_iter=200, tol1=1e-4,
              tol2=1e-4)
    want = jadmm(lowrank(), 5, **kw)
    got = tadmm(t(lowrank()), 5, **kw)
    assert 10 < got.i == want.i < 199
    assert_traces_match(got.obj_history, want.obj_history)


@pytest.mark.parametrize("distance", ["eu", "kl"])
def test_state_carried_from_tpunmf_continues_its_run(distance):
    """tpunmf runs 10 iterations of adaptive ADMM; io/convert.py hands its
    loop state (7 or 9 tensors, rho among them) to the port, which runs
    10 more: the result is tpunmf's 20-iteration run."""
    kw = {**_FIXED, "distance_type": distance, "rho_mode": "adaptive", "rho": 10.0}
    carried = []

    def grab(c):
        if int(c.i) == 10:
            carried.append(c)

    want = jadmm(lowrank(), 5, block_size=10, on_block_end=grab, **kw)
    carry = convert.carry_to_torch(carried[0], dtype=torch.float64)
    assert carry.i == 10 and len(carry.inner) == (9 if distance == "kl" else 7)
    assert carry.inner[-1].dim() == 0 and float(carry.inner[-1]) != 10.0
    out = _admm_block(t(lowrank()), carry, 20, kw["tol1"], kw["tol2"], 0, 0, 2.0,
                      10.0, distance_type=distance, prox_w="nn", prox_h="l2n",
                      rho_mode="adaptive", spd_solver="chol", min_iter=20,
                      max_iter=20, use_pallas=True)
    assert out.i == 20
    assert_traces_match(out.obj_buf.numpy(), np.asarray(want.obj_history))
    back = convert.carry_to_numpy(out)
    np.testing.assert_allclose(back.inner[0], np.asarray(want.w), rtol=1e-8)
    np.testing.assert_allclose(back.inner[1], np.asarray(want.h), rtol=1e-8)


def test_kernel_route_calls_the_kernel_wrappers(monkeypatch):
    """use_pallas=True on float32 V selects the wrappers (plain versions on
    the CPU, with no launch counted); use_pallas=False, the default for
    CPU data, and float64 V call the plain versions only."""
    calls = []
    module = importlib.import_module("tpunmf_torch.solvers.admm")
    for name in ("eu_residual_obj", "kl_ratio_and_obj"):
        real = getattr(tfused, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    before = tfused.kl_ratio_and_obj.launches
    for distance in ("eu", "kl"):
        tadmm(t(lowrank()).float(), 5, distance_type=distance, min_iter=3, max_iter=3,
              use_pallas=True)
        tadmm(t(lowrank()).float(), 5, distance_type=distance, min_iter=3, max_iter=3)
        tadmm(t(lowrank()), 5, distance_type=distance, min_iter=3, max_iter=3,
              use_pallas=True)
    assert calls == ["eu_residual_obj"] * 3 + ["kl_ratio_and_obj"] * 3
    assert tfused.kl_ratio_and_obj.launches == before


def test_facade_admm_save_name_and_round_trip(tmp_path):
    kw = dict(rho=2.0, distance_type="kl", reg_w=(0.1, "l1n"), reg_h=(0.05, "l2n"),
              min_iter=5, max_iter=8)
    want = tpunmf.NMF(lowrank(), 5)
    want.factorize(method="admm", **kw)
    model = tpunmf_torch.NMF(t(lowrank()), 5)
    res = model.factorize(method="admm", **kw)
    assert model.default_save_name() == want.default_save_name() \
        == "nmf_admm_5_kl_2.0_0.1:l1n_0.05:l2n_nndsvdz"
    assert res.experiment._asdict() == want.results.experiment._asdict()
    path = model.save_factorization(save_dir=str(tmp_path))
    loaded = tpunmf_torch.NMF.load_factorization(path)
    np.testing.assert_array_equal(loaded.w, model.w)
    assert loaded.default_save_name() == model.default_save_name()
    assert loaded.results.i == res.i == 7


@pytest.mark.parametrize("kw,exc", [
    (dict(rho_mode="bogus"), ValueError),
    (dict(spd_solver="lu"), ValueError),
    (dict(distance_type="is"), TypeError),
    (dict(w_init=np.ones((60, 5))), ValueError),
    # checkpoints are ported: a checkpoint of another configuration is refused
    (dict(checkpoint_path="ckpt"), ValueError),
])
def test_admm_errors(kw, exc, tmp_path):
    if "checkpoint_path" in kw:
        kw = dict(checkpoint_path=str(tmp_path / "ckpt"), resume=True)
        tadmm(t(lowrank()), 5, max_iter=3, rho=2.0, **kw)
    with pytest.raises(exc):
        tadmm(t(lowrank()), 5, max_iter=3, **kw)


@pytest.mark.parametrize("method", ["chol", "cg"])
def test_spd_solve_matches_tpunmf(method):
    rng = np.random.default_rng(30)
    g = rng.random((12, 12))
    a = g @ g.T + 0.5 * np.eye(12)
    b = rng.random((12, 40))
    want = np.asarray(jlinalg.spd_solve(a, b, method=method))
    got = tlinalg.spd_solve(t(a), t(b), method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(a @ got, b, rtol=1e-9)
    # an explicit CG budget: 3 steps on a 12 x 12 system stop short
    short = tlinalg.spd_solve(t(a), t(b), method="cg", cg_iters=3).numpy()
    np.testing.assert_allclose(
        short, np.asarray(jlinalg.spd_solve(a, b, method="cg", cg_iters=3)),
        rtol=1e-12)
    assert not np.allclose(short, got, rtol=1e-6)


def _prox_inputs(shape=(8, 12), seed=31):
    rng = np.random.default_rng(seed)
    mat = rng.random(shape) * 0.3
    mat[:3] *= 20.0  # rows past the l1 budget; the others fit it
    dual = 0.05 * rng.standard_normal(shape)
    return mat, dual


@pytest.mark.parametrize("name,kw", [
    ("prox_nn", {}),
    ("prox_l1n", dict(rho=1.5, lambda_=0.1)),
    ("prox_l2n", dict(rho=1.5, lambda_=0.3)),
    ("prox_l1inf", dict(rho=1.5, lambda_=0.1)),
    ("prox_l1inf", dict(rho=0.7, lambda_=0.0, upper_bound=2.0)),
    ("prox_l1inf_transpose", dict(rho=1.5, lambda_=0.1)),
])
def test_prox_operators_match_tpunmf(name, kw):
    mat, dual = _prox_inputs()
    if name == "prox_l1inf_transpose":
        mat, dual = mat.T.copy(), dual.T.copy()
    want = np.asarray(getattr(jprox, name)(mat, dual, **kw))
    got = getattr(tprox, name)(t(mat), t(dual), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    # the dispatcher, with rho as a 0-d tensor (as ADMM carries it)
    tkw = {**kw, "rho": torch.tensor(kw["rho"], dtype=torch.float64)} if "rho" in kw else kw
    via = tprox.prox(name[len("prox_"):], t(mat), t(dual), **tkw).numpy()
    np.testing.assert_allclose(via, want, rtol=1e-12, atol=1e-15)
    if name.startswith("prox_l1inf"):
        over = (np.clip(mat + dual - kw["lambda_"] / kw["rho"], 0, None).sum(
            axis=0 if "transpose" in name else 1) > kw.get("upper_bound", 1.0))
        assert over.any() and not over.all()


def test_prox_l1inf_ball_and_unknown_type():
    mat, _ = _prox_inputs()
    want = np.asarray(jprox.prox_l1inf_ball(mat, rho=1.5, lambda_=0.1))
    got = tprox.prox_l1inf_ball(t(mat), rho=1.5, lambda_=0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert got.sum(axis=1).max() <= 1.0 + 1e-12
    with pytest.raises(TypeError, match="Unknown prox_type"):
        tprox.prox("l0", t(mat), t(mat))


def test_sparse_csr_and_densify_are_tpunmf_s():
    want = jsparse_csr(300, 200, density=0.05, k=7, seed=3)
    got = tsparse_csr(300, 200, density=0.05, k=7, seed=3)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(tdensify(got), jdensify(want))
    assert tdensify(got).dtype == np.float32
