"""The two single passes that tpunmf leaves off by default: HALS's
``hals_iteration_eu`` and MUR's "dma" EU variant ``mur_iteration_eu_dma``.

The port's switches (``solvers/cuda_defaults.py``) are held against
``tpunmf``'s defaults, its rules (``hals_iter_tileable``,
``iter_eu_dma_tileable``) and MUR's route against ``tpunmf``'s on ``meta``
tensors, the plain versions against ``tpunmf``'s Pallas kernel in
interpret mode (the DMA kernel has none: ``mur_iteration_eu`` is its CPU
oracle, tpunmf/ops/mur_fused.py:470-472), and the solvers with each
switch flipped against ``tpunmf``: at float64 iterate for iterate (the
rule sends float64 to the plain route, so the tests force the single
pass), and HALS at float32 against ``tpunmf``'s own single pass.  The
CUDA kernels run only on the card (tests/test_torch_cuda.py).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunmf_torch
from _torch_parity import KERNEL_RTOL, assert_traces_match, kernel_problem, lowrank, t
from tpunmf.ops import hals_sweep as jhals_sweep
from tpunmf.ops import mur_fused as jmur_fused
from tpunmf.solvers import hals as jhals
from tpunmf.solvers import mur as jmur
from tpunmf.solvers import tpu_defaults
from tpunmf_torch.ops import hals_sweep, mur_fused
from tpunmf_torch.solvers import cuda_defaults

port_mur = importlib.import_module("tpunmf_torch.solvers.mur")
port_hals = importlib.import_module("tpunmf_torch.solvers.hals")
jhals_mod = importlib.import_module("tpunmf.solvers.hals")


def test_switches_are_tpunmf_s_defaults():
    """tpunmf's values on its TPU (the only device where it reads them)."""
    for device in (torch.device("cuda"), torch.device("cpu")):
        assert cuda_defaults.mur_single_pass_variant(device) == \
            tpu_defaults.mur_single_pass_variant("tpu") == "auto"
        assert cuda_defaults.hals_single_pass(device) is \
            tpu_defaults.hals_single_pass("tpu") is False


# the paths' shapes, the tests' shapes and shapes on both sides of the budgets
SHAPES = [(8192, 8192), (8192, 16384), (8192, 4096), (20000, 11000), (64, 48),
          (64, 128), (96, 128), (60, 48), (32, 48), (1000, 777), (16384, 2048)]
RANKS = (1, 8, 16, 37, 128, 256, 264, 1024)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rules_and_dma_route_are_tpunmf_s(shape, dtype, monkeypatch):
    meta = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    spec = jax.ShapeDtypeStruct(shape, getattr(jnp, dtype))
    for k in RANKS:
        assert hals_sweep.hals_iter_tileable(meta, k) == jhals_sweep.hals_iter_tileable(spec, k)
        assert mur_fused.iter_eu_dma_tileable(meta, k) == \
            jmur_fused.iter_eu_dma_tileable(spec, k)
    # tpunmf/solvers/mur.py:409-419 with its variant set to "dma"
    monkeypatch.setattr(cuda_defaults, "mur_single_pass_variant", lambda device: "dma")
    for k in RANKS:
        single = jmur_fused.iter_eu_tileable(spec, k)
        route = port_mur.mur_route(meta, k, "eu")
        if single is None:
            assert route == ("plain" if dtype == "float64" else "pair", None)
            continue
        dma = jmur_fused.iter_eu_dma_tileable(spec, k)
        assert route == ("single", single if dma is None else ("dma", dma))
        assert port_mur.mur_route(meta, k, "kl")[1] == jmur_fused.iter_kl_tileable(spec, k)


@pytest.mark.parametrize("dist,shape,dtype,k,auto,dma", [
    ("eu", (8192, 8192), "float32", 128, 64, ("dma", 64)),
    ("eu", (8192, 8192), "bfloat16", 128, 128, ("dma", 128)),
    ("eu", (64, 48), "float32", 5, 64, ("dma", 32)),
    ("eu", (32, 48), "float32", 5, 32, 32),  # one strip: nothing to double-buffer
    ("kl", (8192, 4096), "float32", 128, (128, None), (128, None)),
])
def test_dma_route_table(dist, shape, dtype, k, auto, dma, monkeypatch):
    """The switch moves only the EU single pass, and only where tpunmf's
    DMA rule gives at least 2 strips."""
    meta = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    assert port_mur.mur_route(meta, k, dist) == ("single", auto)
    monkeypatch.setattr(cuda_defaults, "mur_single_pass_variant", lambda device: "dma")
    assert port_mur.mur_route(meta, k, dist) == ("single", dma)


# bf16 X: both sides round H and W' to bf16 in the products; W' itself
# differs by f32 rounding (the TPU kernel keeps W G as a running rank-1
# update, the plain version recomputes each dot product), and a W' entry
# that lands on the other side of a bf16 rounding boundary moves its
# wtx terms by up to 2^-8 relative: observed 8.2e-5 at these shapes
BF16_WTX_TOL = 5e-4


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lam", [0.0, 0.05])
@pytest.mark.parametrize("nsweeps", [1, 2])
@pytest.mark.parametrize("m,n,k,bm", [(64, 48, 8, 16), (96, 128, 16, 32)])
def test_hals_iteration_plain_version_matches_pallas_kernel(m, n, k, bm, nsweeps, lam, xdtype):
    x, w, h = kernel_problem(30 + k, m=m, n=n, k=k)
    xj = jnp.asarray(x).astype(getattr(jnp, xdtype))
    want = jhals_sweep.hals_iteration_eu(xj, jnp.asarray(w), jnp.asarray(h), lam_w=lam,
                                         nsweeps=nsweeps, bm=bm, interpret=True)
    before = hals_sweep.hals_iteration_eu.launches
    got = hals_sweep.hals_iteration_eu(t(x).to(getattr(torch, xdtype)), t(w), t(h), lam_w=lam,
                                       nsweeps=nsweeps, bm=bm)
    assert hals_sweep.hals_iteration_eu.launches == before  # CPU: the plain version
    # tpunmf's own tolerances for its kernel (tests/test_ops.py:382-387)
    tols = (2e-5, 2e-4, 2e-4) if xdtype == "float32" else (2e-5, BF16_WTX_TOL, 2e-4)
    for g, j, tol in zip(got, want, tols):
        assert g.dtype == torch.float32 and g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_hals_iteration_checks_the_strips_as_tpunmf():
    x, w, h = (t(a) for a in kernel_problem(31, m=64, n=48, k=8))
    with pytest.raises(ValueError, match="bm=48 must divide m=64"):
        hals_sweep.hals_iteration_eu(x, w, h, lam_w=0.0, nsweeps=1, bm=48)


@pytest.mark.parametrize("xdtype,lam", [("float32", 0.0), ("float32", 0.3),
                                        ("bfloat16", 0.0), ("bfloat16", 0.3)])
def test_dma_plain_version_matches_tpunmf_s_oracle(xdtype, lam):
    """tpunmf's DMA kernel has no interpret mode; its docstring names
    mur_iteration_eu as the oracle, run here in interpret mode."""
    x, w, h = kernel_problem(32)
    xj = jnp.asarray(x).astype(getattr(jnp, xdtype))
    want = jmur_fused.mur_iteration_eu(xj, jnp.asarray(w), jnp.asarray(h), lam_w=lam,
                                       bm=32, interpret=True)
    before = mur_fused.mur_iteration_eu_dma.launches
    got = mur_fused.mur_iteration_eu_dma(t(x).to(getattr(torch, xdtype)), t(w), t(h),
                                         lam_w=lam, bm=32)
    assert mur_fused.mur_iteration_eu_dma.launches == before
    for g, j in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=KERNEL_RTOL)


def test_dma_wrapper_needs_two_strips_as_tpunmf():
    x, w, h = (t(a) for a in kernel_problem(33))  # m = 64
    with pytest.raises(ValueError, match="at least 2 strips"):
        mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=64)
    with pytest.raises(ValueError, match="bm=48 must divide m=64"):
        mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=48)


def _counted(monkeypatch, module, names):
    calls = []
    for name in names:
        monkeypatch.setattr(module, name, lambda *a, _fn=getattr(module, name), _n=name,
                            **k: calls.append(_n) or _fn(*a, **k))
    return calls


# ---------------------------------------------- the switched routes at f64

_INIT = np.random.default_rng(3)
_W0, _H0 = _INIT.random((60, 5)) + 0.1, _INIT.random((5, 48)) + 0.1
HALS_CASES = {
    "sweeps2_exact_nndsvd_zero": dict(),
    "sweeps1_gram": dict(inner_sweeps=1, objective="gram"),
    "sweeps3_lambda_explicit": dict(inner_sweeps=3, lambda_w=0.1, lambda_h=0.3,
                                    w_init=_W0, h_init=_H0),
    "converges": dict(tol2=1e-3, min_iter=2, max_iter=200),
}
_HALS_BASE = dict(min_iter=4, max_iter=25, tol1=1e-12, tol2=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_hals(name):
    return jhals(lowrank(), 5, **{**_HALS_BASE, **HALS_CASES[name]})


@pytest.mark.parametrize("name", list(HALS_CASES))
def test_hals_single_pass_matches_tpunmf_at_f64(name, monkeypatch):
    kw = {**_HALS_BASE, **HALS_CASES[name]}
    monkeypatch.setattr(cuda_defaults, "hals_single_pass", lambda device: True)
    monkeypatch.setattr(port_hals, "sweep_takes", lambda x, k: True)
    monkeypatch.setattr(port_hals, "hals_iter_tileable", lambda x, k: 12)  # divides m = 60
    calls = _counted(monkeypatch, port_hals, ("hals_iteration_eu", "gs_sweep"))
    got = port_hals.hals(t(lowrank()), 5, use_pallas=True, **kw)
    want = _jax_hals(name)
    iters = got.i + 1
    assert calls.count("hals_iteration_eu") == iters and calls.count("gs_sweep") == iters
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=1e-8, atol=1e-12)
    if name == "converges":
        assert 2 < got.i < 199


MUR_CASES = {
    "eu_exact": dict(),
    "eu_gram": dict(objective="gram"),
    "eu_lambda": dict(lambda_w=0.1, lambda_h=0.3),
    "eu_objective_every_3": dict(objective_every=3),
    "eu_converges": dict(tol2=0.3, min_iter=3),
}
_MUR_BASE = dict(distance_type="eu", min_iter=5, max_iter=40, tol1=1e-9, tol2=1e-9,
                 nndsvd_init=(True, "zero"))


@functools.lru_cache(maxsize=None)
def _jax_mur(name):
    return jmur(lowrank(), 5, use_pallas=False, **{**_MUR_BASE, **MUR_CASES[name]})


@pytest.mark.parametrize("name", list(MUR_CASES))
def test_mur_dma_route_matches_tpunmf_at_f64(name, monkeypatch):
    kw = {**_MUR_BASE, **MUR_CASES[name]}
    monkeypatch.setattr(cuda_defaults, "mur_single_pass_variant", lambda device: "dma")
    monkeypatch.setattr(port_mur, "updates_take", lambda x, k: True)
    monkeypatch.setattr(port_mur, "iter_eu_tileable", lambda x, k: 60)
    monkeypatch.setattr(port_mur, "iter_eu_dma_tileable", lambda x, k: 12)  # 5 strips
    calls = _counted(monkeypatch, port_mur, ("mur_iteration_eu", "mur_iteration_eu_dma",
                                             "mur_w_update"))
    got = port_mur.mur(t(lowrank()), 5, use_pallas=True, **kw)
    want = _jax_mur(name)
    assert calls == ["mur_iteration_eu_dma"] * (got.i + 1)
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=1e-8, atol=1e-12)


# ------------------------------------------ the switched routes at f32

def test_factorize_takes_the_switched_routes_where_tpunmf_does(monkeypatch):
    """f32 X through NMF.factorize(use_pallas=True) on the CPU: with the
    switches off the default routes, with them on the single passes
    wherever tpunmf's rules give a strip height."""
    mcalls = _counted(monkeypatch, port_mur, ("mur_iteration_eu", "mur_iteration_eu_dma"))
    hcalls = _counted(monkeypatch, port_hals, ("hals_iteration_eu", "gs_sweep"))
    x = t(lowrank(m=64, n=48).astype(np.float32))
    kw = dict(max_iter=4, use_pallas=True)
    tpunmf_torch.NMF(x, 5).factorize(method="mur", distance_type="eu", **kw)
    tpunmf_torch.NMF(x, 8).factorize(method="hals", **kw)
    assert mcalls == ["mur_iteration_eu"] * 4 and hcalls == ["gs_sweep"] * 8
    mcalls.clear()
    hcalls.clear()
    monkeypatch.setattr(cuda_defaults, "mur_single_pass_variant", lambda device: "dma")
    monkeypatch.setattr(cuda_defaults, "hals_single_pass", lambda device: True)
    spec = jax.ShapeDtypeStruct((64, 48), jnp.float32)
    assert jmur_fused.iter_eu_dma_tileable(spec, 5) == 32
    assert jhals_sweep.hals_iter_tileable(spec, 8) == 64
    assert jhals_sweep.hals_iter_tileable(spec, 5) is None  # k % 8
    tpunmf_torch.NMF(x, 5).factorize(method="mur", distance_type="eu", **kw)
    tpunmf_torch.NMF(x, 8).factorize(method="hals", **kw)
    assert mcalls == ["mur_iteration_eu_dma"] * 4
    assert hcalls == ["hals_iteration_eu", "gs_sweep"] * 4
    hcalls.clear()
    tpunmf_torch.NMF(x, 5).factorize(method="hals", **kw)
    assert hcalls == ["gs_sweep"] * 8
    hcalls.clear()
    tpunmf_torch.NMF(t(lowrank(m=64, n=48)), 8).factorize(method="hals", **kw)  # f64
    assert hcalls == []


def test_hals_single_pass_at_f32_matches_tpunmf_s_single_pass(monkeypatch):
    """The model of tests/test_ops.py:329-363: tpunmf's HALS with its
    single pass on (its Pallas kernels in interpret mode) against the
    port's with its switch on, 10 iterations at float32.  The TPU kernel
    keeps W G as a running rank-1 update, the port's sweep recomputes each
    dot product: f32 rounding apart.  Observed: 2.8e-6 on the trace,
    1.9e-5 on W and 5.7e-5 on H (|got - want| / (1 + |want|))."""
    monkeypatch.setattr(tpu_defaults, "hals_single_pass", lambda backend: True)
    monkeypatch.setattr(tpu_defaults, "hals_use_sweep_kernel", lambda backend: True)
    for name in ("hals_iteration_eu", "gs_sweep"):
        monkeypatch.setattr(jhals_mod, name, lambda *a, _fn=getattr(jhals_mod, name),
                            **k: _fn(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(cuda_defaults, "hals_single_pass", lambda device: True)
    calls = _counted(monkeypatch, port_hals, ("hals_iteration_eu", "gs_sweep",
                                              "eu_residual_obj"))
    rng = np.random.default_rng(34)
    x = lowrank(m=64, n=128).astype(np.float32)
    w0 = (rng.random((64, 8)) + 0.1).astype(np.float32)
    h0 = (rng.random((8, 128)) + 0.1).astype(np.float32)
    kw = dict(min_iter=10, max_iter=10, tol1=0.0, tol2=0.0, lambda_w=0.1, w_init=w0,
              h_init=h0)
    want = jhals(x, 8, **kw)
    got = port_hals.hals(t(x), 8, use_pallas=True, **kw)
    assert calls.count("hals_iteration_eu") == calls.count("gs_sweep") == 10
    assert calls.count("eu_residual_obj") == 11
    assert got.i == want.i == 9 and got.w.dtype == np.float32
    assert_traces_match(got.obj_history, want.obj_history, rtol=1e-5)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=2e-4, atol=2e-4)
