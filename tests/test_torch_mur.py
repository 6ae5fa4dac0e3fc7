"""The slice: tpunmf_torch's MUR against tpunmf's, iterate for iterate.

Both run on the CPU at float64 from the same numpy inputs; the port is run
on both of its routes (``use_pallas=True`` takes the fused steps, whose
wrappers run their plain versions on the CPU, and ``use_pallas=False``
the plain steps).  The traces must agree to 1e-10 relative with the same
final ``i`` and NaN in the same places.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import assert_traces_match, lowrank, t
from tpunmf.core import convergence as jconv
from tpunmf.init import nndsvd as jnndsvd
from tpunmf.solvers import mur as jmur
from tpunmf_torch.core import convergence as tconv
from tpunmf_torch.init import nndsvd as tnndsvd
from tpunmf_torch.init import random_init, randomized_svd
from tpunmf_torch.io import convert
from tpunmf_torch.ops import mur_fused as tmur_fused
from tpunmf_torch.solvers import mur as tmur
from tpunmf_torch.solvers.mur import _mur_block

_BASE = dict(min_iter=5, max_iter=40, tol1=1e-9, tol2=1e-9,
             nndsvd_init=(True, "zero"))
_INIT = np.random.default_rng(3)
_W0, _H0 = _INIT.random((60, 5)) + 0.1, _INIT.random((5, 48)) + 0.1

CASES = {
    "eu_exact_nndsvd_zero": dict(distance_type="eu"),
    "kl_exact_nndsvd_zero": dict(distance_type="kl"),
    "eu_gram_nndsvd_mean": dict(distance_type="eu", objective="gram",
                                nndsvd_init=(True, "mean")),
    "kl_gram_nndsvd_mean": dict(distance_type="kl", objective="gram",
                                nndsvd_init=(True, "mean")),
    "eu_explicit_init": dict(distance_type="eu", w_init=_W0, h_init=_H0),
    "kl_explicit_init": dict(distance_type="kl", w_init=_W0, h_init=_H0),
    "eu_lambda": dict(distance_type="eu", lambda_w=0.1, lambda_h=0.3),
    "kl_lambda": dict(distance_type="kl", lambda_w=0.2, lambda_h=0.05),
    "eu_negative_data": dict(distance_type="eu", shift=-0.3),
    "kl_negative_data": dict(distance_type="kl", shift=-0.3),
    "eu_objective_every_3": dict(distance_type="eu", objective_every=3),
    "kl_objective_every_3": dict(distance_type="kl", objective_every=3),
    # converges (tol2 fires) well before max_iter
    "eu_converges": dict(distance_type="eu", tol2=0.3, min_iter=3),
    "kl_converges": dict(distance_type="kl", tol2=0.3, min_iter=3,
                         max_iter=200),
}


def _data(case):
    return lowrank() + case.get("shift", 0.0)


def _kwargs(case):
    return {**_BASE, **{k: v for k, v in case.items() if k != "shift"}}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    case = CASES[name]
    return tpunmf.NMF(_data(case), 5).factorize(method="mur", **_kwargs(case))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("name", list(CASES))
def test_slice_matches_tpunmf(name, use_pallas):
    case = CASES[name]
    want = _jax_run(name)
    model = tpunmf_torch.NMF(t(_data(case)), 5)
    got = model.factorize(method="mur", use_pallas=use_pallas, **_kwargs(case))
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)
    if "every_3" in name:
        assert np.isnan(got.obj_history).sum() > 10
    if "converges" in name:
        assert 3 < got.i < _kwargs(case)["max_iter"] - 1
    np.testing.assert_allclose(model.w, np.asarray(want.w), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(model.h, np.asarray(want.h), rtol=1e-8, atol=1e-12)
    assert model.w.dtype == np.float64


@pytest.mark.parametrize("name", ["kl_exact_nndsvd_zero", "kl_lambda",
                                  "kl_explicit_init", "kl_converges"])
def test_lagged_trace_is_tpunmf_exact_trace_shifted_by_one(name):
    """objective='lagged' on the fused route records, at iteration i, the
    objective of the iterate entering it: lagged[i+1] == exact[i] and
    lagged[0] == exact[0]; a convergence stop comes one iteration later
    (tpunmf/solvers/mur.py:199-235)."""
    case = CASES[name]
    kw = _kwargs(case)
    want = _jax_run(name)
    before = tmur_fused.mur_w_update.lagged_launches
    got = tmur(t(_data(case)), 5, use_pallas=True, objective="lagged", **kw)
    assert tmur_fused.mur_w_update.lagged_launches == before  # CPU: plain version
    lagged, exact = np.asarray(got.obj_history), np.asarray(want.obj_history)
    assert_traces_match(lagged[:1], exact[:1])
    if name == "kl_converges":
        # away from the min_iter boundary: the exact stop lies beyond min_iter + 1
        assert want.i > kw["min_iter"] + 1 and got.i == want.i + 1
        assert_traces_match(lagged[1:], exact)
    else:
        assert got.i == want.i == kw["max_iter"] - 1
        assert_traces_match(lagged[1:], exact[:-1])
    # the plain route ignores 'lagged', as tpunmf's step_kl does
    plain = tmur(t(_data(case)), 5, use_pallas=False, objective="lagged", **kw)
    assert plain.i == want.i
    assert_traces_match(plain.obj_history, want.obj_history)


def test_lagged_objective_every_records_on_refresh_iterations_only():
    """With objective_every=3 the lagged W pass runs on refresh iterations
    ((i+1) % 3 == 0, and the last possible one) and the obj-free pass
    otherwise; each recorded value is still tpunmf's exact[i]."""
    case = CASES["kl_exact_nndsvd_zero"]
    kw = _kwargs(case)
    want = np.asarray(_jax_run("kl_exact_nndsvd_zero").obj_history)
    got = tmur(t(_data(case)), 5, use_pallas=True, objective="lagged",
               objective_every=3, **kw)
    assert got.i == kw["max_iter"] - 1
    lagged = np.asarray(got.obj_history)
    refresh = np.array([(i + 1) % 3 == 0 or i + 1 >= kw["max_iter"]
                        for i in range(kw["max_iter"])])
    np.testing.assert_array_equal(~np.isnan(lagged[1:]), refresh)
    assert_traces_match(lagged[:1], want[:1])
    assert_traces_match(lagged[1:][refresh], want[:-1][refresh])


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("distance", ["eu", "kl"])
def test_blocks_and_on_block_end_match_tpunmf(distance, use_pallas):
    kw = dict(_BASE, distance_type=distance, max_iter=30, block_size=7)
    seen_j, seen_t = [], []
    want = jmur(lowrank(), 5, on_block_end=lambda c: seen_j.append(int(c.i)), **kw)
    got = tmur(t(lowrank()), 5, use_pallas=use_pallas,
               on_block_end=lambda c: seen_t.append(c.i), **kw)
    assert seen_t == seen_j == [7, 14, 21, 28, 30]
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("distance", ["eu", "kl"])
def test_state_carried_from_tpunmf_continues_its_run(distance, use_pallas):
    """tpunmf runs 10 iterations; io/convert.py hands its loop state to the
    port, which runs 10 more: the result is tpunmf's 20-iteration run."""
    kw = dict(_BASE, distance_type=distance, max_iter=20)
    carried = []

    def grab(c):
        if int(c.i) == 10:
            carried.append(c)

    want = jmur(lowrank(), 5, block_size=10, on_block_end=grab, **kw)
    carry = convert.carry_to_torch(carried[0], dtype=torch.float64)
    if use_pallas:  # the fused route carries (w, h) only
        carry = carry._replace(inner=carry.inner[:2])
    assert carry.i == 10 and len(carry.inner) == (2 if use_pallas or distance == "eu" else 3)
    out = _mur_block(t(lowrank()), torch.zeros((), dtype=torch.float64), carry, 20,
                     kw["tol1"], kw["tol2"], 0.0, 0.0, distance_type=distance,
                     min_iter=kw["min_iter"], max_iter=20, objective="exact",
                     use_pallas=use_pallas)
    assert out.i == 20
    assert_traces_match(out.obj_buf.numpy(), np.asarray(want.obj_history))
    back = convert.carry_to_numpy(out)
    np.testing.assert_allclose(back.inner[0], np.asarray(want.w), rtol=1e-8)
    np.testing.assert_allclose(back.inner[1], np.asarray(want.h), rtol=1e-8)


def test_bf16_plain_route_matches_tpunmf_plain_route():
    """bf16 X, f32 factors: plain route against plain route (the fused
    route rounds the factor to bf16 in its products; the plain one not)."""
    x = lowrank().astype(np.float32)
    kw = dict(_BASE, distance_type="eu", max_iter=15)
    want = jmur(x, 5, data_dtype=jnp.bfloat16, use_pallas=False, **kw)
    got = tmur(t(x), 5, data_dtype=torch.bfloat16, use_pallas=False, **kw)
    assert got.w.dtype == np.float32 and got.obj_history[0].dtype == np.float32
    assert got.i == want.i
    # f32 sums in another order, compounded over 15 iterations
    assert_traces_match(got.obj_history, want.obj_history, rtol=1e-4)


@pytest.mark.parametrize("dtype,data_dtype,factor", [
    (torch.float64, None, torch.float64),
    (torch.float32, None, torch.float32),
    (torch.float32, torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
def test_no_dtype_drift(dtype, data_dtype, factor, use_pallas):
    """Elevation and the epilogue constants keep X's dtype; factors are f32
    for bf16 X (tpunmf mur.py:375-378)."""
    x = t(lowrank() - 0.2).to(dtype)
    res = tmur(x, 5, distance_type="kl", max_iter=3, data_dtype=data_dtype,
               use_pallas=use_pallas)
    want = np.dtype(str(factor).replace("torch.", ""))
    assert res.w.dtype == want and res.h.dtype == want
    assert np.asarray(res.obj_history).dtype == want
    assert np.all(np.isfinite(res.obj_history))


@pytest.mark.parametrize("init", ["nndsvd", "fortran_w_init"])
def test_kernel_route_gets_row_major_operands(init, monkeypatch):
    """The CUDA wrappers refuse strided operands; torch's SVD returns a
    column-major U, so mur() must hand over contiguous factors and X."""
    port_mur = importlib.import_module("tpunmf_torch.solvers.mur")
    seen = []

    def checked(fn):
        def wrapper(x, w, h, **kw):
            seen.append(all(a.is_contiguous() for a in (x, w, h)))
            return fn(x, w, h, **kw)
        return wrapper

    for name in ("mur_w_update", "mur_h_update", "kl_obj"):
        monkeypatch.setattr(port_mur, name, checked(getattr(port_mur, name)))
    x = t(np.asfortranarray(lowrank()))
    assert not x.is_contiguous()
    kw = (dict(nndsvd_init=(True, "zero")) if init == "nndsvd" else
          dict(w_init=np.asfortranarray(_W0), h_init=np.asfortranarray(_H0)))
    tmur(x, 5, distance_type="kl", max_iter=3, use_pallas=True, **kw)
    assert len(seen) == 10 and all(seen)


def test_random_init_is_seeded_and_explicit():
    a = random_init(0, 6, 5, 3, dtype=torch.float64)
    b = random_init(torch.Generator().manual_seed(0), 6, 5, 3, dtype=torch.float64)
    c = random_init(1, 6, 5, 3, dtype=torch.float64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert (a[0] >= 0).all() and a[0].shape == (6, 3) and a[1].shape == (3, 5)
    r1 = tmur(t(lowrank()), 5, distance_type="kl", max_iter=5, key=4)
    r2 = tmur(t(lowrank()), 5, distance_type="kl", max_iter=5, key=4)
    np.testing.assert_array_equal(r1.obj_history, r2.obj_history)


@pytest.mark.parametrize("variant", ["zero", "mean"])
def test_nndsvd_matches_tpunmf(variant):
    x = lowrank()
    jw, jh = jnndsvd(jnp.asarray(x), 5, variant=variant)
    tw, th = tnndsvd(t(x), 5, variant=variant)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-9, atol=1e-12)


def test_nndsvd_random_fill_and_randomized_svd():
    x = lowrank()
    zw, zh = tnndsvd(t(x), 5, variant="zero")
    rw, rh = tnndsvd(t(x), 5, variant="random", key=1)
    assert torch.equal(rw[zw != 0], zw[zw != 0])
    fill = rw[zw == 0]
    assert fill.numel() and (fill > 0).all() and (fill <= x.mean() / 100).all()
    s_exact = np.linalg.svd(x, compute_uv=False)[:5]
    _, s, _ = randomized_svd(t(x), 5, key=0)
    np.testing.assert_allclose(s.numpy(), s_exact, rtol=1e-6)
    mw, _ = tnndsvd(t(x), 5, method="randomized", key=0)
    np.testing.assert_allclose(mw.numpy(), zw.numpy(), rtol=1e-3, atol=1e-3)


def test_convergence_predicates_match_tpunmf():
    for new, old in [(1.0, 1.0), (0.5, 1.0), (1e-6, 1.0), (1.0 - 1e-5, 1.0),
                     (1.0 - 2e-5, 1.0), (2.0, 1.0)]:
        want = bool(jconv.converged(new, old, 1e-5, 1e-5))
        assert tconv.convergence_check(new, old, 1e-5, 1e-5) == want
        assert bool(tconv.converged(torch.tensor(new), torch.tensor(old),
                                    1e-5, 1e-5)) == want
