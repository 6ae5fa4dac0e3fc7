"""tpunmf_torch's HALS against tpunmf's: the sweep's plain version against
tpunmf's Pallas sweep kernel (interpret mode), and the solver iterate for
iterate at float64 on the CPU (traces to 1e-10, the same final ``i``)."""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import F64_RUN, assert_traces_match, f32, f64_distance, lowrank, t
from tpunmf.ops import hals_sweep as jsweep
from tpunmf.solvers import hals as jhals
from tpunmf_torch.io import convert
from tpunmf_torch.ops import hals_sweep as tsweep
from tpunmf_torch.solvers import hals as thals

_JHALS = importlib.import_module("tpunmf.solvers.hals")  # the module: jhals is its solver

# tpunmf's own tolerance for its sweep kernel against the XLA chain
# (tests/test_ops.py:305): f32 sums of k terms in another order
SWEEP_TOL = 2e-5


def _sweep_problem(m=24, n=16, k=8, seed=11):
    """tests/test_ops.py's sweep problem (smaller: the interpreted kernel
    unrolls k steps per sweep), as numpy f32."""
    rng = np.random.default_rng(seed)
    x = (rng.random((m, k)) @ rng.random((k, n)) + 0.05).astype(np.float32)
    w = rng.random((m, k)).astype(np.float32) + 0.1
    h = rng.random((k, n)).astype(np.float32) + 0.1
    return x, w, h


@pytest.mark.parametrize("frame", ["w", "h"])
@pytest.mark.parametrize("nsweeps", [1, 2])
@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_sweep_plain_version_matches_pallas_kernel(lam, nsweeps, frame):
    x, w, h = _sweep_problem()
    if frame == "w":  # transposed frame of the W half
        a, g, v = (x @ h.T).T, h @ h.T, w.T
    else:
        a, g, v = w.T @ x, w.T @ w, h
    want = np.asarray(jsweep.gs_sweep(jnp.asarray(a), jnp.asarray(g), jnp.asarray(v),
                                      lam=lam, nsweeps=nsweeps, bm=8, interpret=True))
    before = tsweep.gs_sweep.launches
    # the wrapper on CPU tensors (the W frame as strided views) is the plain version
    got = tsweep.gs_sweep(t(a.T).T if frame == "w" else t(a), t(g),
                          t(v.T).T if frame == "w" else t(v), lam=lam, nsweeps=nsweeps)
    assert tsweep.gs_sweep.launches == before
    assert got.dtype == torch.float32 and got.shape == v.shape
    assert got.T.is_contiguous() == (frame == "w")
    np.testing.assert_allclose(got.numpy(), want, rtol=SWEEP_TOL, atol=SWEEP_TOL)


def _blocked_sweeps(a, g, v, lam, nsweeps, b):
    """The CUDA sweep's order of work (tpunmf_torch/ops/csrc/gs_panel.cuh)
    written out in numpy: for each panel of b rows, P = G[panel, :] V from
    V as it stands, then the panel's steps, numer = (A - P + G_ll V_old) -
    corr and V = max(numer / d, 0) with d = (G_ll + lam) + eps formed once,
    each step adding G[r, l] delta into corr for the panel's later rows r."""
    v = v.copy()
    k = v.shape[0]
    diag = np.diag(g).copy()
    d = (diag + lam) + 1e-16
    for _ in range(nsweeps):
        for l0 in range(0, k, b):
            l1 = min(l0 + b, k)
            base = (a[l0:l1] - g[l0:l1] @ v) + diag[l0:l1, None] * v[l0:l1]
            corr = np.zeros_like(base)
            for i, l in enumerate(range(l0, l1)):
                new = np.maximum((base[i] - corr[i]) / d[l], 0.0)
                delta = new - v[l]
                v[l] = new
                corr[i + 1:] += g[l + 1:l1, l, None] * delta[None, :]
    return v


@functools.lru_cache(maxsize=None)
def _plain_sweeps(frame, k, lam, nsweeps):
    """(a, g, v) of a float64 sweep problem in the transposed frame, and
    tpunmf's sweeps on it (_hals_sweep_w on W, or _hals_sweep_h on H)."""
    rng = np.random.default_rng(100 + k)
    m, n, r = 30, 23, 4
    x = rng.random((m, r)) @ rng.random((r, n)) + 0.05
    w, h = rng.random((m, k)) + 0.1, rng.random((k, n)) + 0.1
    if frame == "w":
        a, g, v = (x @ h.T).T, h @ h.T, w.T
        sweep, state, args = _JHALS._hals_sweep_w, w, (x @ h.T, h @ h.T)
    else:
        a, g, v = w.T @ x, w.T @ w, h
        sweep, state, args = _JHALS._hals_sweep_h, h, (w.T @ x, w.T @ w)
    state = jnp.asarray(state)
    for _ in range(nsweeps):
        state = sweep(state, *(jnp.asarray(t_) for t_ in args), lam)
    want = np.asarray(state)
    return a, g, v, want.T if frame == "w" else want


@pytest.mark.parametrize("frame", ["w", "h"])
@pytest.mark.parametrize("nsweeps", [1, 2])
@pytest.mark.parametrize("lam", [0.0, 0.3])
@pytest.mark.parametrize("k", [5, 37, 64])  # 37: a ragged last panel
@pytest.mark.parametrize("b", [1, 8, 32])
def test_blocked_sweep_order_matches_tpunmf_at_f64(b, k, lam, nsweeps, frame):
    """The kernel's blocked Gauss-Seidel (panel products, in-panel
    corrections, d formed once) is the same function as tpunmf's chain:
    at float64 within 1e-12, in both frames."""
    a, g, v, want = _plain_sweeps(frame, k, lam, nsweeps)
    assert want.dtype == np.float64
    got = _blocked_sweeps(a, g, v, lam, nsweeps, b)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert (got >= 0).all()


def test_sweep_bounds_count_the_sweeps_as_f32_products():
    """ops/roofline.py: the sweeps' 2 k^2 flops a column a sweep are
    products of G's panels with V (f32 products, 3xTF32), in gs_sweep and
    inside hals_iteration_eu; at the HALS path's shape the bytes bind."""
    from tpunmf_torch.ops import roofline

    assert roofline.sweep_flops(128, 8192, 2) == (0.0, 0.0, 4.0 * 8192 * 128 * 128)
    assert roofline.sweep_flops(37, 1000, 0) == (0.0, 0.0, 0.0)
    m, n, k = 300, 777, 40
    sweeps = roofline.sweep_flops(k, m, 2)[2]
    grams = 2.0 * k * k * (m + n)
    assert roofline.hals_flops(m, n, k, False, 2) == (0.0, 0.0, 4.0 * m * n * k + grams + sweeps)
    assert roofline.hals_flops(m, n, k, True, 2) == (0.0, 4.0 * m * n * k, grams + sweeps)
    nbytes = 4.0 * (128 * 128 + 3 * 128 * 8192)
    f32, bf16, product = roofline.sweep_flops(128, 8192, 2)
    ms, by = roofline.bound(f32, bf16, nbytes, product)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / roofline.PEAK_BYTES)


_BASE = dict(min_iter=4, max_iter=25, tol1=1e-12, tol2=1e-12)
_INIT = np.random.default_rng(0)
_W0, _H0 = _INIT.random((60, 5)) + 0.1, _INIT.random((5, 48)) + 0.1

CASES = {
    "sweeps1_exact_nndsvd_zero": dict(inner_sweeps=1),
    "sweeps3_exact_explicit": dict(inner_sweeps=3, w_init=_W0, h_init=_H0),
    "sweeps2_gram_nndsvd_mean": dict(objective="gram", nndsvd_init=(True, "mean")),
    "lambda_exact": dict(lambda_w=0.1, lambda_h=0.3, w_init=_W0, h_init=_H0),
    "lambda_gram_sweeps3": dict(lambda_w=0.2, lambda_h=0.05, inner_sweeps=3,
                                objective="gram"),
    "negative_data": dict(shift=-0.3),
    # converges (tol2 fires) well before max_iter
    "converges": dict(tol2=1e-3, min_iter=2, max_iter=200),
}


def _data(case):
    return lowrank() + case.get("shift", 0.0)


def _kwargs(case):
    return {**_BASE, **{k: v for k, v in case.items() if k != "shift"}}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    case = CASES[name]
    return tpunmf.NMF(_data(case), 5).factorize(method="hals", **_kwargs(case))


@pytest.mark.parametrize("name", list(CASES))
def test_hals_matches_tpunmf(name):
    case = CASES[name]
    want = _jax_run(name)
    model = tpunmf_torch.NMF(t(_data(case)), 5)
    got = model.factorize(method="hals", **_kwargs(case))
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)
    if name == "converges":
        assert 2 < got.i < 199
    np.testing.assert_allclose(model.w, np.asarray(want.w), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(model.h, np.asarray(want.h), rtol=1e-8, atol=1e-12)
    assert model.w.dtype == np.float64


def test_kernel_route_at_f32_sweeps_with_gs_sweep_and_matches_tpunmf(monkeypatch):
    """float32 X on the kernel route: both halves go through gs_sweep (its
    plain version on the CPU) and the objective through eu_residual_obj;
    float64 X stays on the plain route (the f32 gate of tpunmf's sweep
    kernel, tpunmf/solvers/hals.py:236-237)."""
    port = importlib.import_module("tpunmf_torch.solvers.hals")
    calls = []

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapper

    for name in ("gs_sweep", "eu_residual_obj"):
        monkeypatch.setattr(port, name, counting(name, getattr(port, name)))
    x = lowrank().astype(np.float32)
    kw = dict(min_iter=10, max_iter=10, tol1=0.0, tol2=0.0)
    got = thals(t(x), 5, use_pallas=True, **kw)
    assert calls.count("gs_sweep") == 20 and calls.count("eu_residual_obj") == 11
    calls.clear()
    thals(t(lowrank()), 5, use_pallas=True, **kw)
    assert calls == []
    want = jhals(x, 5, **kw)
    assert got.w.dtype == np.float32
    assert_traces_match(got.obj_history, want.obj_history, rtol=1e-5)


def test_blocks_and_on_block_end_match_tpunmf():
    kw = dict(_BASE, max_iter=20, block_size=6)
    seen_j, seen_t = [], []
    want = jhals(lowrank(), 5, on_block_end=lambda c: seen_j.append(int(c.i)), **kw)
    got = thals(t(lowrank()), 5, on_block_end=lambda c: seen_t.append(c.i), **kw)
    assert seen_t == seen_j == [6, 12, 18, 20]
    assert_traces_match(got.obj_history, want.obj_history)


def test_generated_inits_are_nudged_and_explicit_ones_are_not():
    """NNDSVD 'zero' leaves exact zeros; HALS lifts generated inits to
    1e-16 (tpunmf/solvers/hals.py:221-225), not w_init/h_init."""
    w0 = _W0.copy()
    w0[:, 2] = 0.0
    kw = dict(min_iter=1, max_iter=1, tol1=0.0, tol2=0.0)
    want = jhals(lowrank(), 5, w_init=w0, h_init=_H0, **kw)
    got = thals(t(lowrank()), 5, w_init=w0, h_init=_H0, **kw)
    assert_traces_match(got.obj_history, want.obj_history)
    kw = dict(min_iter=0, max_iter=0)  # no iteration: the init comes back
    want = jhals(lowrank(), 5, **kw)
    got = thals(t(lowrank()), 5, **kw)
    assert (got.w == 1e-16).any() and (got.h >= 1e-16).all()
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=1e-9, atol=0)


def test_hals_errors_and_inert_sweep_unroll(tmp_path):
    with pytest.raises(KeyError):
        thals(t(lowrank()), 4, distance_type="kl")
    with pytest.raises(ValueError):
        thals(t(lowrank()), 4, inner_sweeps=0)
    with pytest.raises(ValueError):
        thals(t(lowrank()), 4, w_init=_W0)
    # checkpoints are ported: a checkpoint of other sweeps is refused
    ck = str(tmp_path / "ckpt")
    thals(t(lowrank()), 5, max_iter=3, checkpoint_path=ck)
    with pytest.raises(ValueError, match="configuration mismatch"):
        thals(t(lowrank()), 5, max_iter=3, checkpoint_path=ck, resume=True,
              inner_sweeps=1)
    a = thals(t(lowrank()), 5, max_iter=5, sweep_unroll=1)
    b = thals(t(lowrank()), 5, max_iter=5, sweep_unroll=8)
    np.testing.assert_array_equal(a.obj_history, b.obj_history)


def test_facade_names_files_and_carries_results_as_tpunmf(tmp_path):
    kw = dict(min_iter=3, max_iter=8, lambda_w=0.5)
    jm = tpunmf.NMF(lowrank(), 4)
    jm.factorize(method="hals", **kw)
    tm = tpunmf_torch.NMF(t(lowrank()), 4)
    tm.factorize(method="hals", **kw)
    assert tm.default_save_name() == jm.default_save_name()
    assert tm.default_save_name().startswith("nmf_hals_4_eu")
    path = tm.save_factorization(save_dir=str(tmp_path))
    loaded = tpunmf_torch.NMF.load_factorization(path)
    np.testing.assert_array_equal(loaded.w, tm.w)
    assert loaded.default_save_name() == tm.default_save_name()
    back = tpunmf.NMF.load_factorization(path)
    assert back.results.experiment._asdict() == tm.results.experiment._asdict()
    carried = convert.results_to_torch(jm.results, dtype=torch.float64)
    assert carried.experiment.method == "hals" and carried.w.dtype == torch.float64
    np.testing.assert_array_equal(convert.results_to_numpy(carried).h, np.asarray(jm.h))


# HALS's plain f32 route against tpunmf's float64 trace over 50 iterations
# at 256 x 192 k16: 1.4e-6 to 1.6e-5 over four seeded inits (the objective
# falls to the noise floor within a few sweeps, where 0.5 ||X - W H||^2
# cancels), so past 5e-6 at some inits, where chip_smoke.py's
# float64 gate on the card is twice the plain route's distance
HALS_F64_RTOL = 2e-5


@pytest.mark.parametrize("inner_sweeps", [1, 2])
def test_plain_f32_route_stays_near_tpunmf_float64(inner_sweeps):
    """50 HALS iterations at 256 x 192 k16: the port's plain f32 route within
    HALS_F64_RTOL of tpunmf's float64 trace at every iteration, the
    yardstick of chip_smoke.py's float64 gate."""
    x = lowrank(5, 256, 192, 16)
    rng = np.random.default_rng(8)
    w0, h0 = rng.random((256, 16)) + 0.1, rng.random((16, 192)) + 0.1
    kw = dict(method="hals", inner_sweeps=inner_sweeps, **F64_RUN)
    want = tpunmf.NMF(x, 16).factorize(w_init=w0, h_init=h0, **kw).obj_history
    xt, wt, ht = f32(x, w0, h0)
    got = tpunmf_torch.NMF(xt, 16).factorize(w_init=wt, h_init=ht, use_pallas=False,
                                             **kw).obj_history
    assert f64_distance(got, want) <= HALS_F64_RTOL
