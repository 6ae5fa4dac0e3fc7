"""tpunmf_torch's AO-ADMM slice against tpunmf's, on the CPU at float64.

``solvers/ao_admm`` and ``solvers/ao_admm_local`` get the same numpy inputs
as tpunmf's.  The traces are compared over fixed budgets (min_iter =
max_iter) on both of the port's routes, and the inner loops' trips call by
call against tpunmf's run eagerly; one convergent EU run and one KL run
must stop at the same ``i``.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import assert_traces_match, lowrank, t
from tpunmf.solvers import ao_admm as jao_admm
from tpunmf_torch import data as tdata
from tpunmf_torch.ops import fused as tfused
from tpunmf_torch.solvers import ao_admm as tao_admm

jmod = importlib.import_module("tpunmf.solvers.ao_admm")
jlocal = importlib.import_module("tpunmf.solvers.ao_admm_local")
tmod = importlib.import_module("tpunmf_torch.solvers.ao_admm")
tlocal = importlib.import_module("tpunmf_torch.solvers.ao_admm_local")

_FIXED = dict(min_iter=20, max_iter=20, tol1=1e-10, tol2=1e-10,
              nndsvd_init=(True, "zero"))
_INIT = np.random.default_rng(7)
_W0, _H0 = _INIT.random((60, 5)) + 0.1, _INIT.random((5, 48)) + 0.1
_LOCAL = dict(rho_mode="adaptive", reg_w=(0.1, "l1inf"))

CASES = {
    "eu_defaults": dict(distance_type="eu"),
    "eu_l1n_h": dict(distance_type="eu", reg_h=(0.1, "l1n")),
    "kl_nn": dict(distance_type="kl", reg_w=(0, "nn"), reg_h=(0, "nn")),
    # BASELINE config[4]'s regularizers (benchmarks/run_configs.py:242)
    "kl_config4": dict(distance_type="kl", reg_w=(0.05, "l1n"), reg_h=(0.05, "l2n")),
    "eu_adaptive_l1n": dict(distance_type="eu", rho_mode="adaptive", reg_h=(0.1, "l1n")),
    "kl_adaptive": dict(distance_type="kl", rho_mode="adaptive"),
    "eu_local": dict(distance_type="eu", **_LOCAL),
    "kl_local": dict(distance_type="kl", **_LOCAL),
    "eu_l1inf_fixed": dict(distance_type="eu", reg_w=(0.2, "l1inf")),
    "eu_cg": dict(distance_type="eu", spd_solver="cg"),
    "kl_explicit_init": dict(distance_type="kl", w_init=_W0, h_init=_H0),
}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    return jao_admm(lowrank(), 5, **{**_FIXED, **CASES[name]})


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("name", list(CASES))
def test_ao_admm_matches_tpunmf(name, use_pallas):
    want = _jax_run(name)
    got = tao_admm(t(lowrank()), 5, use_pallas=use_pallas, block_size=7,
                   **{**_FIXED, **CASES[name]})
    assert got.i == want.i == 19
    assert_traces_match(got.obj_history, want.obj_history)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=1e-8, atol=1e-12)
    assert got.w.dtype == np.float64 and got.w.min() >= 0 and got.h.min() >= 0
    assert got.experiment._asdict() == want.experiment._asdict()


def _counting(real, seq):
    """An inner loop that appends each call's trip count to ``seq``."""
    def loop(body, state, n_iter, *args):
        seq.append(0)

        def counted(s):
            seq[-1] += 1
            return body(s)
        return real(counted, state, n_iter, *args)
    return loop


@pytest.mark.parametrize("name", ["eu_defaults", "eu_adaptive_l1n", "kl_adaptive",
                                  "eu_local", "kl_local"])
def test_inner_trips_are_tpunmf_s_call_by_call(name, monkeypatch):
    """tpunmf run eagerly (its while loops as Python loops) counts each inner
    loop's trips; the port's host loops take the same trips, subproblem by
    subproblem, and ``trips`` adds them up per side.  25 trips allowed, so
    that loops stop on their residual test (10 is reached at most calls)."""
    kw = {**_FIXED, "min_iter": 5, "max_iter": 5, "admm_iter": 25, **CASES[name]}
    want, got = [], []
    jloop, tloop = _counting(jmod.inner_loop, want), _counting(tmod._inner_loop, got)
    for mod in (jmod, jlocal):
        monkeypatch.setattr(mod, "inner_loop", jloop)
    for mod in (tmod, tlocal):
        monkeypatch.setattr(mod, "_inner_loop", tloop)
    with jax.disable_jit():
        jao_admm(lowrank(), 5, **kw)
    tmod.trips.reset()
    tao_admm(t(lowrank()), 5, **kw)
    assert len(got) == 10 and got == want
    assert 0 < min(got) < 25
    assert tmod.trips.as_dict() == {"h_calls": 5, "h": sum(got[0::2]),
                                    "w_calls": 5, "w": sum(got[1::2])}


@pytest.mark.parametrize("distance", ["eu", "kl"])
def test_convergent_run_stops_at_tpunmf_s_iteration(distance):
    kw = dict(distance_type=distance, min_iter=10, max_iter=200, tol1=1e-4,
              tol2=1e-4)
    want = jao_admm(lowrank(), 5, **kw)
    got = tao_admm(t(lowrank()), 5, **kw)
    assert 10 < got.i == want.i < 199
    assert_traces_match(got.obj_history, want.obj_history)


@pytest.mark.parametrize("upper_bound", [1.0, 16.0])
def test_local_sparsity_diverges_as_tpunmf_does_below_the_data_s_scale(upper_bound):
    """The local-sparsity variant at rank 32 on lowrank_dense: with the
    default l1 budget of 1, far below the planted W's row norms (about
    k/2 = 16), tpunmf's iterates blow up and turn NaN, and the port's
    follow them there (rounding amplified on the way) without raising;
    with the budget at 16 both converge together."""
    x = tdata.lowrank_dense(96, 80, 32, seed=0, dtype=np.float64)
    kw = dict(min_iter=30, max_iter=30, upper_bound=upper_bound, **_LOCAL)
    want = np.asarray(jao_admm(x, 32, **kw).obj_history)
    got = np.asarray(tao_admm(t(x), 32, **kw).obj_history)
    if upper_bound == 16.0:
        assert_traces_match(got, want)
        assert want[-1] < 0.01 * want[0]
        return
    assert_traces_match(got[:10], want[:10], rtol=1e-8)
    assert np.nanmax(want) > 1e6 * want[0] and np.nanmax(got) > 1e6 * got[0]
    assert not np.isfinite(want[-1]) and not np.isfinite(got[-1])


def _balance_inputs(case):
    rng = np.random.default_rng(40)
    dual = rng.standard_normal((5, 9))
    r, s = {"up": (3.0, 0.1), "down": (0.1, 3.0), "hold": (1.0, 0.5)}[case]
    return 2.0, r, s, dual


@pytest.mark.parametrize("clamp", [False, True], ids=["free", "clamped"])
@pytest.mark.parametrize("case", ["up", "down", "hold"])
def test_balance_rho_matches_tpunmf(case, clamp):
    rho, r, s, dual = _balance_inputs(case)
    bounds = dict(lo=1.5, hi=3.0) if clamp else {}
    want_rho, want_dual = jlocal.balance_rho(
        jnp.asarray(rho), jnp.asarray(r), jnp.asarray(s), jnp.asarray(dual), tau=2.0,
        eta=10.0, **{n: jnp.asarray(b) for n, b in bounds.items()})
    f64 = functools.partial(torch.tensor, dtype=torch.float64)
    got_rho, got_dual = tlocal.balance_rho(
        f64(rho), f64(r), f64(s), t(dual), tau=2.0, eta=10.0,
        **{n: f64(b) for n, b in bounds.items()})
    assert float(got_rho) == float(want_rho)
    assert (float(got_rho) == rho) == (case == "hold")
    np.testing.assert_allclose(got_dual.numpy(), np.asarray(want_dual), rtol=1e-15)


def _split_inputs():
    rng = np.random.default_rng(41)
    v = lowrank()
    w, h = rng.random((60, 5)) + 0.1, rng.random((5, 48)) + 0.1
    v_aux = v + 0.05 * rng.random(v.shape)
    dual_v = 0.01 * rng.standard_normal(v.shape)
    dual_h = 0.01 * rng.standard_normal(h.shape)
    return v, v_aux, dual_v, w, h, dual_h


@pytest.mark.parametrize("frame", ["h", "w"])
def test_kl_update_matches_tpunmf(frame):
    """One KL subproblem: the H frame on V, and the W frame on the
    transposes (views in the port, whose outputs keep V's layout)."""
    v, v_aux, dual_v, w, h, dual_h = _split_inputs()
    args = (v, v_aux, dual_v, w, h, dual_h)
    if frame == "w":  # dual_h stands in for dual_w: any (k, n) array
        args = (v.T, v_aux.T, dual_v.T, h.T, w.T, 0.01 * dual_v[:, :5].T)
    want = jmod._admm_kl_update(*(jnp.asarray(a) for a in args), 5, "l1n", 10, 0.05)
    targs = [t(a) for a in (v, v_aux, dual_v, w, h, dual_h)]
    if frame == "w":
        targs = [targs[0].T, targs[1].T, targs[2].T, targs[4].T, targs[3].T,
                 t(0.01 * dual_v[:, :5]).T]
    got = tmod._admm_kl_update(*targs, 5, "l1n", 10, 0.05)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-9, atol=1e-13)
    # the split's outputs are laid out as V: row-major in its own frame
    assert got[2].T.is_contiguous() == got[3].T.is_contiguous() == (frame == "w")


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_local_sparsity_update_matches_tpunmf(adaptive):
    v, _, _, w, h, _ = _split_inputs()
    rng = np.random.default_rng(42)
    w_aux, dual_w = w + 0.1 * rng.random(w.shape), 0.01 * rng.standard_normal(w.shape)
    want = jlocal.admm_local_sparsity_update(
        *(jnp.asarray(a) for a in (v, w, w_aux, dual_w, h)), 5, 10, 0.1,
        jnp.asarray(1.0), adaptive, jnp.asarray(2.0), jnp.asarray(10.0), "chol")
    got = tlocal.admm_local_sparsity_update(
        *(t(a) for a in (v, w, w_aux, dual_w, h)), 5, 10, 0.1, 1.0, adaptive, 2.0, 10.0,
        "chol")
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-9, atol=1e-13)
    assert got[1].sum(dim=1).max() <= 1.0 + 1e-12  # W_aux on the l1 ball


def test_a_zero_dual_never_terminates():
    h = torch.ones(3, 4, dtype=torch.float64)
    assert not bool(tmod._terminated(h, h, h, torch.zeros_like(h)))  # 0/0
    assert not bool(tmod._terminated(h, h + 1e-9, h, torch.zeros_like(h)))  # x/0
    assert bool(tmod._terminated(h, h, h, torch.ones_like(h)))


@pytest.mark.parametrize("variant", ["fixed", "adaptive", "local"])
def test_kl_state_stays_row_major(variant):
    """After each KL iteration the carried v_aux and dual_v are (m, n) and
    row-major, though the W subproblem works on their transposes."""
    kw = {"fixed": {}, "adaptive": dict(rho_mode="adaptive"), "local": _LOCAL}[variant]
    seen = []
    tao_admm(t(lowrank()), 5, distance_type="kl", min_iter=3, max_iter=3,
             block_size=1, on_block_end=lambda c: seen.append(c.inner[-2:]), **kw)
    assert len(seen) == 3
    for v_aux, dual_v in seen:
        assert v_aux.shape == dual_v.shape == (60, 48)
        assert v_aux.is_contiguous() and dual_v.is_contiguous()


def test_kernel_route_calls_kl_obj_and_never_the_ratio(monkeypatch):
    """use_pallas=True on float32 V calls the objective wrappers once an
    iteration (their plain versions on the CPU, no launch counted), KL's
    kl_obj and never kl_ratio_and_obj; use_pallas=False and float64 V call
    the plain versions directly."""
    calls = []
    for mod, names in ((tmod, ("eu_residual_obj", "kl_obj", "eu_residual_obj_ref",
                               "kl_obj_ref")),
                       (tfused, ("kl_obj_ref", "kl_ratio_and_obj", "kl_ratio_and_obj_ref"))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=f"{mod.__name__}.{name}",
                                **kw: calls.append(_n) or _r(*a, **kw))
    before = tfused.kl_obj.launches
    x32 = t(lowrank()).float()
    for distance in ("eu", "kl"):
        tao_admm(x32, 5, distance_type=distance, min_iter=3, max_iter=3, use_pallas=True)
        tao_admm(x32, 5, distance_type=distance, min_iter=3, max_iter=3)
        tao_admm(t(lowrank()), 5, distance_type=distance, min_iter=3, max_iter=3,
                 use_pallas=True)
    solver, ops = tmod.__name__, tfused.__name__
    assert calls == ([f"{solver}.eu_residual_obj"] * 3 + [f"{solver}.eu_residual_obj_ref"] * 6
                     + [f"{solver}.kl_obj", f"{ops}.kl_obj_ref"] * 3
                     + [f"{solver}.kl_obj_ref"] * 6)
    assert tfused.kl_obj.launches == before


@pytest.mark.parametrize("kw", [
    dict(rho_mode="bogus"),
    dict(spd_solver="lu"),
    dict(distance_type="is"),
    dict(w_init=np.ones((60, 5))),
], ids=["rho_mode", "spd_solver", "distance", "init"])
def test_ao_admm_errors_are_tpunmf_s(kw):
    with pytest.raises(Exception) as want:
        jao_admm(lowrank(), 5, max_iter=3, **kw)
    with pytest.raises(type(want.value)) as got:
        tao_admm(t(lowrank()), 5, max_iter=3, **kw)
    assert str(got.value) == str(want.value)


def test_bfloat16_and_checkpoints_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="bfloat16"):
        jao_admm(jnp.asarray(lowrank(), dtype=jnp.bfloat16), 5, max_iter=3)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tao_admm(t(lowrank()).bfloat16(), 5, max_iter=3)
    # checkpoints are ported: a saved run resumes at its end, and a fixed-rho
    # checkpoint is refused by an adaptive run (rho_mode is in the tag)
    ck = str(tmp_path / "ckpt")
    done = tao_admm(t(lowrank()), 5, min_iter=3, max_iter=3, checkpoint_path=ck)
    again = tao_admm(t(lowrank()), 5, min_iter=3, max_iter=3, checkpoint_path=ck,
                     resume=True)
    np.testing.assert_array_equal(again.w, done.w)
    assert again.obj_history == done.obj_history
    with pytest.raises(ValueError, match="configuration mismatch"):
        tao_admm(t(lowrank()), 5, min_iter=3, max_iter=3, checkpoint_path=ck,
                 resume=True, rho_mode="adaptive")


def test_facade_ao_admm_save_name_and_round_trip(tmp_path):
    kw = {**_FIXED, **CASES["kl_config4"]}
    want = tpunmf.NMF(lowrank(), 5)
    want.results = _jax_run("kl_config4")
    model = tpunmf_torch.NMF(t(lowrank()), 5)
    res = model.factorize(method="ao_admm", **kw)
    direct = tao_admm(t(lowrank()), 5, **kw)
    np.testing.assert_array_equal(res.w, direct.w)
    np.testing.assert_array_equal(res.h, direct.h)
    assert res.obj_history == direct.obj_history and res.i == direct.i == 19
    assert model.default_save_name() == want.default_save_name() \
        == "nmf_ao_admm_5_kl_0.05:l1n_0.05:l2n_nndsvdz"
    path = model.save_factorization(save_dir=str(tmp_path))
    loaded = tpunmf_torch.NMF.load_factorization(path)
    np.testing.assert_array_equal(loaded.w, model.w)
    np.testing.assert_array_equal(loaded.h, model.h)
    assert loaded.default_save_name() == model.default_save_name()
    assert loaded.results.experiment._asdict() == res.experiment._asdict()
