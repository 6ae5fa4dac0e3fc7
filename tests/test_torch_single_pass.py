"""MUR's single-pass routes and the entry points' device rule.

The single-pass plain versions are held against ``tpunmf``'s Pallas kernels
in interpret mode; the port's route predicates against ``tpunmf``'s; the
single-pass steps of the port's solver (at f64, where the predicates give
None, so their strip heights are set by hand) against ``tpunmf``'s plain
route, iterate for iterate.  The CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunmf_torch
from _torch_parity import KERNEL_RTOL, SUM_RTOL, assert_traces_match, kernel_problem, lowrank, t
from tpunmf.ops import mur_fused as jmur_fused
from tpunmf.solvers import mur as jmur
from tpunmf_torch.core.device import as_input
from tpunmf_torch.ops import mur_fused as tmur_fused
from tpunmf_torch.ops import roofline
from tpunmf_torch.serve import topk as ttopk
from tpunmf_torch.solvers import admm, hals, mur, mur_masked

port_mur = importlib.import_module("tpunmf_torch.solvers.mur")


@pytest.mark.parametrize("xdtype,lam", [("float32", 0.0), ("float32", 0.3),
                                        ("bfloat16", 0.0)])
def test_iteration_eu_matches_pallas_kernel(xdtype, lam):
    x, w, h = kernel_problem(20)
    xj = jnp.asarray(x).astype(getattr(jnp, xdtype))
    want = jmur_fused.mur_iteration_eu(xj, jnp.asarray(w), jnp.asarray(h), lam_w=lam,
                                       bm=32, interpret=True)
    xt = t(x).to(getattr(torch, xdtype))
    before = tmur_fused.mur_iteration_eu.launches
    got = tmur_fused.mur_iteration_eu(xt, t(w), t(h), lam_w=lam, bm=32)
    assert tmur_fused.mur_iteration_eu.launches == before  # CPU: plain version
    # bf16 X: both sides round the same operands (H, and w_new before
    # W'^T X) to bf16, so f32 tolerance holds (observed 5e-7)
    for g, j in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=KERNEL_RTOL)
    if xdtype == "bfloat16":  # the rounding of w_new before W'^T X matters
        unrounded = (got[0].T @ xt.float()).numpy()
        assert not np.allclose(got[1].numpy(), unrounded, rtol=1e-6)


@pytest.mark.parametrize("bs", [None, 64])
@pytest.mark.parametrize("lam", [0.0, 0.2])
def test_iteration_kl_matches_pallas_kernel_with_zeros(lam, bs):
    x, w, h = kernel_problem(21, zeros=True)
    assert (x == 0).mean() > 0.1
    want_w, want_r, want_o = jmur_fused.mur_iteration_kl(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), lam_w=lam, bm=32, bs=bs,
        interpret=True)
    got_w, got_r, got_o = tmur_fused.mur_iteration_kl(t(x), t(w), t(h), lam_w=lam,
                                                      bm=32, bs=bs)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=KERNEL_RTOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=KERNEL_RTOL)
    assert got_o.dim() == 0 and np.isfinite(float(got_o))
    np.testing.assert_allclose(float(got_o), float(want_o), rtol=SUM_RTOL)
    # the objective is the lagged W pass's: the masked KL of the incoming (w, h)
    _, lagged = tmur_fused.mur_w_update(t(x), t(w), t(h), distance_type="kl", lam=lam,
                                        with_lagged_obj=True)
    assert torch.equal(got_o, lagged)


@pytest.mark.parametrize("k,pair", [(1, True), (37, True), (tmur_fused.KL_W_TC_RANK, True),
                                    (tmur_fused.KL_ITER_PAIR_RANK, True),
                                    (tmur_fused.KL_ITER_PAIR_RANK + 1, False), (1024, False)])
def test_iteration_kl_is_the_pair_s_plain_passes_composed(k, pair):
    """On the card mur_iteration_kl runs the pair's KL bodies up to
    KL_ITER_PAIR_RANK (between the W pass's tensor-core line and the H
    pass's) and its own FMA waves above it; on the CPU, on either side of
    the line, its plain version is the pair's plain passes composed, bit
    for bit: the lagged W pass, then the H pass's numerator at its W."""
    assert tmur_fused.iteration_kl_on_pair(k) is pair
    assert tmur_fused.KL_W_TC_RANK <= tmur_fused.KL_ITER_PAIR_RANK < tmur_fused.KL_H_TC_RANK
    x, w, h = (t(a) for a in kernel_problem(23, m=9, n=7, k=k, zeros=True))
    before = tmur_fused.mur_iteration_kl.launches
    w_new, wtr, obj = tmur_fused.mur_iteration_kl(x, w, h, lam_w=0.1, bm=9)
    w_pair, obj_pair = tmur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.1,
                                               with_lagged_obj=True)
    numer = tmur_fused.mur_h_update(x, w_new, h, distance_type="kl", lam=0.1)[1]
    assert torch.equal(w_new, w_pair) and torch.equal(obj, obj_pair)
    assert torch.equal(wtr, numer)
    assert tmur_fused.mur_iteration_kl.launches == before


def test_iteration_wrappers_check_the_strips_as_tpunmf():
    x, w, h = (t(a) for a in kernel_problem(22))
    with pytest.raises(ValueError, match="bm=48 must divide m=64"):
        tmur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=48)
    with pytest.raises(ValueError, match="bm=48 must divide m=64"):
        tmur_fused.mur_iteration_kl(x, w, h, lam_w=0.0, bm=48)
    with pytest.raises(ValueError, match="bs=100 must divide n=128"):
        tmur_fused.mur_iteration_kl(x, w, h, lam_w=0.0, bm=32, bs=100)


# the route table of the single pass (tpunmf's own rule), with every shape
# of it, small shapes the tests run, and shapes on both sides of the budget
PREDICATE_SHAPES = [(8192, 8192), (8192, 16384), (20000, 11000), (8192, 4096),
                    (64, 48), (60, 48), (128, 96), (4096, 4096), (16384, 2048),
                    (1000, 777)]
RANKS = (1, 16, 50, 128, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("shape", PREDICATE_SHAPES)
def test_route_predicates_are_tpunmf_s(shape, dtype):
    meta = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    spec = jax.ShapeDtypeStruct(shape, getattr(jnp, dtype))
    for k in RANKS:
        assert tmur_fused.iter_eu_tileable(meta, k) == jmur_fused.iter_eu_tileable(spec, k)
        assert tmur_fused.iter_kl_tileable(meta, k) == jmur_fused.iter_kl_tileable(spec, k)


@pytest.mark.parametrize("dist,shape,dtype,route", [
    ("eu", (8192, 8192), "float32", 64),
    ("eu", (8192, 8192), "bfloat16", 128),
    ("eu", (8192, 16384), "float32", None),
    ("kl", (20000, 11000), "float32", None),
    ("kl", (8192, 4096), "float32", (128, None)),
])
def test_route_table(dist, shape, dtype, route):
    """Single pass where tpunmf takes it, the 2-pass pair elsewhere."""
    meta = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    pred = tmur_fused.iter_eu_tileable if dist == "eu" else tmur_fused.iter_kl_tileable
    k = 50 if shape == (20000, 11000) else 128
    assert pred(meta, k) == route


def test_roofline_bound_is_the_larger_time():
    """One GFLOP-second of f32 work, or of bytes, is 1 ms at the peaks."""
    assert roofline.bound(67e9, 0.0, 1e6) == (1.0, "operations")
    assert roofline.bound(1e6, 0.0, 3.35e9) == (1.0, "bytes")
    assert roofline.bound(0.0, 989e9, 0.0) == (1.0, "operations")
    # f32 products at 3xTF32: 495 / 3 TFLOP/s
    assert roofline.bound(0.0, 0.0, 0.0, 165e9) == (1.0, "operations")
    # EU products of a bf16 X run on both-bf16 operands, the Grams and the
    # W G product are f32 products; KL's products are f32 products
    m, n, k = 64, 32, 8
    f32, bf16, product = roofline.mur_flops("mur_iteration_eu", m, n, k, True)
    assert f32 == 0.0 and bf16 == 4.0 * m * n * k
    assert product == 2.0 * k * k * (m + n) + 2.0 * m * k * k
    assert roofline.mur_flops("mur_iteration_kl", m, n, k, True) == (0.0, 0.0, 8.0 * m * n * k)
    # every TPU kernel is ported; the sweep scripts' variants: v1 is the EU
    # single pass, v2 adds Gw H (2 k k n), int8 X multiplies in bf16
    assert roofline._unported() == []
    assert roofline.mur_flops("v1_iter", m, n, k, True) == (f32, bf16, product)
    assert roofline.mur_flops("v1_iter", m, n, k, False) == (0.0, 0.0, product + bf16)
    assert roofline.mur_flops("v2_iter", m, n, k, True) == (f32, bf16, product + 2.0 * k * k * n)
    assert roofline.mur_flops("iter_eu_int8", m, n, k, False) == (f32, bf16, product)
    assert roofline.read_probe_flops(m, n) == (2.0 * m * n, 0.0, 0.0)
    # the HALS single pass at 2 sweeps: two products against X, the Grams
    # and 2 sweeps of k steps of 2k flops a row, G's panels times the rows
    # of W (f32 products, csrc/gs_panel.cuh)
    assert roofline.hals_flops(m, n, k, False, 2) == (
        0.0, 0.0, 4.0 * m * n * k + 2.0 * k * k * (m + n) + 4.0 * m * k * k)
    assert roofline.hals_flops(m, n, k, True, 1)[1] == 4.0 * m * n * k


@pytest.mark.parametrize("case,shape,want_ms,want_by", [
    # masked_h_update at MovieLens-10M r64, f32 X and a uint8 mask:
    # 6 m n k of f32 products against 3.75 GB
    ("masked", (69878, 10677, 64), 1.736, "operations"),
    # kl_ratio_and_obj at BASELINE config[3]: 2 m n k against X read and
    # the ratio written, 8.04 GB
    ("ratio", (50000, 20000, 128), 2.399, "bytes"),
    # and at MUR's high rank: the products bind
    ("ratio", (8192, 4096, 1536), 0.625, "operations"),
    # mur_h_update's KL body at BASELINE config[1]: S and one product, 4 m n
    # k, against X (880 MB) and W, H read and H', the numerator written:
    # the two are within 0.4% (0.2667 ms of products, 0.2658 of bytes)
    ("kl_h", (20000, 11000, 50), 0.267, "operations"),
    # its EU body at 8192 x 8192 r128, f32 X: W^T X and the Grams
    ("eu_h", (8192, 8192, 128), 0.107, "operations"),
    # mur_iteration_eu there: two products against X, the Grams and W Gh
    ("eu_iter", (8192, 8192, 128), 0.213, "operations"),
])
def test_roofline_charges_f32_products_at_three_tf32(case, shape, want_ms, want_by):
    m, n, k = shape
    factors = 4.0 * (m * k + k * n)
    if case == "masked":  # X f32 and M uint8 read, W and H read, H written
        flops, nbytes = roofline.masked_flops(m, n, k), 5.0 * m * n + factors + 4.0 * k * n
    elif case in ("kl_h", "eu_h"):  # X f32, W, H read; H' and the numerator written
        flops = roofline.mur_flops("mur_h_update", m, n, k, False, case[:2])
        nbytes = 4.0 * m * n + factors + 8.0 * k * n
        if case == "kl_h":
            assert roofline.bound(*flops[:2], nbytes)[1] == "bytes"  # without the products
    elif case == "eu_iter":  # X, W, H read; W', W'^T X and the Gram written
        flops = roofline.mur_flops("mur_iteration_eu", m, n, k, False)
        nbytes = 4.0 * m * n + 2 * factors + 4.0 * k * k
    else:  # X f32 read, the f32 ratio written
        flops, nbytes = roofline.mur_flops("kl_ratio_and_obj", m, n, k, False), 8.0 * m * n + factors
    f32, bf16, product = flops
    assert f32 == bf16 == 0.0
    ms, by = roofline.bound(f32, bf16, nbytes, product)
    if case == "kl_h":
        assert 4.0 * m * n * k == product
        assert abs(1e3 * nbytes / roofline.PEAK_BYTES - ms) < 0.004 * ms
    assert (round(ms, 3), by) == (want_ms, want_by)
    # at the f32 FMA rate the same products would take 495 / 3 / 67 = 2.46x as long
    assert roofline.bound(product, 0.0, 0.0)[0] == pytest.approx(
        roofline.bound(0.0, 0.0, 0.0, product)[0] * 165 / 67)


# single-pass routes at f64 against tpunmf's plain route
_BASE = dict(min_iter=5, max_iter=40, tol1=1e-9, tol2=1e-9, nndsvd_init=(True, "zero"))
SINGLE_CASES = {
    "eu_exact": dict(distance_type="eu"),
    "eu_gram": dict(distance_type="eu", objective="gram"),
    "eu_lambda": dict(distance_type="eu", lambda_w=0.1, lambda_h=0.3),
    "eu_objective_every_3": dict(distance_type="eu", objective_every=3),
    "eu_converges": dict(distance_type="eu", tol2=0.3, min_iter=3),
    "kl_exact": dict(distance_type="kl"),
    "kl_lambda": dict(distance_type="kl", lambda_w=0.2, lambda_h=0.05),
    "kl_objective_every_3": dict(distance_type="kl", objective_every=3),
    "kl_converges": dict(distance_type="kl", tol2=0.3, min_iter=3, max_iter=200),
}


@functools.lru_cache(maxsize=None)
def _plain_jax_run(name):
    return jmur(lowrank(), 5, use_pallas=False, **{**_BASE, **SINGLE_CASES[name]})


def _single_pass_run(monkeypatch, objective=None, **kw):
    """The port's mur() with the single pass forced at f64 (the rule sends
    f64 to the plain route; bm 12 divides lowrank()'s m = 60); returns the
    result and the single-pass calls."""
    calls = []

    def counted(fn):
        def wrapper(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(port_mur, "updates_take", lambda x, k: True)
    monkeypatch.setattr(port_mur, "iter_eu_tileable", lambda x, k: 12)
    monkeypatch.setattr(port_mur, "iter_kl_tileable", lambda x, k: (12, None))
    for name in ("mur_iteration_eu", "mur_iteration_kl", "mur_w_update", "mur_h_update"):
        monkeypatch.setattr(port_mur, name, counted(getattr(port_mur, name)))
    if objective is not None:
        kw["objective"] = objective
    res = mur(t(lowrank()), 5, use_pallas=True, **kw)
    return res, calls


@pytest.mark.parametrize("name", list(SINGLE_CASES))
def test_single_pass_route_matches_tpunmf_at_f64(name, monkeypatch):
    kw = {**_BASE, **SINGLE_CASES[name]}
    want = _plain_jax_run(name)
    got, calls = _single_pass_run(monkeypatch, **kw)
    kernel = "mur_iteration_" + kw["distance_type"]
    assert calls == [kernel] * (got.i + 1)
    assert got.i == want.i
    assert_traces_match(got.obj_history, want.obj_history)
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.h, np.asarray(want.h), rtol=1e-8, atol=1e-12)
    if "converges" in name:
        assert 3 < got.i < kw["max_iter"] - 1


@pytest.mark.parametrize("name", ["kl_exact", "kl_lambda", "kl_converges"])
def test_single_pass_lagged_trace_is_tpunmf_exact_trace_shifted_by_one(name, monkeypatch):
    kw = {**_BASE, **SINGLE_CASES[name]}
    want = _plain_jax_run(name)
    got, calls = _single_pass_run(monkeypatch, objective="lagged", **kw)
    assert set(calls) == {"mur_iteration_kl"}
    lagged, exact = np.asarray(got.obj_history), np.asarray(want.obj_history)
    assert_traces_match(lagged[:1], exact[:1])
    if name == "kl_converges":
        assert want.i > kw["min_iter"] + 1 and got.i == want.i + 1
        assert_traces_match(lagged[1:], exact)
    else:
        assert got.i == want.i == kw["max_iter"] - 1
        assert_traces_match(lagged[1:], exact[:-1])


@pytest.mark.parametrize("dist,shape", [("eu", (64, 48)), ("eu", (60, 48)),
                                        ("kl", (128, 96)), ("kl", (60, 48))])
def test_factorize_takes_the_single_pass_where_tpunmf_does(dist, shape, monkeypatch):
    """f32 X through NMF.factorize(use_pallas=True) on the CPU: the single
    pass exactly where tpunmf's predicate gives a strip height."""
    calls = []
    for name in ("mur_iteration_eu", "mur_iteration_kl", "mur_w_update"):
        fn = getattr(port_mur, name)
        monkeypatch.setattr(port_mur, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    x = lowrank(m=shape[0], n=shape[1]).astype(np.float32)
    spec = jax.ShapeDtypeStruct(shape, jnp.float32)
    tileable = jmur_fused.iter_eu_tileable if dist == "eu" else jmur_fused.iter_kl_tileable
    single = tileable(spec, 5) is not None
    assert single == (shape != (60, 48))
    res = tpunmf_torch.NMF(t(x), 5).factorize(method="mur", distance_type=dist, max_iter=6,
                                              use_pallas=True)
    want = ["mur_iteration_" + dist] if single else ["mur_w_update"]
    assert calls == want * 6
    assert np.all(np.isfinite(res.obj_history)) and res.w.dtype == np.float32


# ---------------------------------------------------------- the device rule

def test_a_tensor_keeps_its_device_and_other_input_follows():
    x = t(lowrank())
    assert as_input(x) is x
    assert as_input(np.ones(3), device=x.device).device.type == "cpu"
    got = mur(x, 5, distance_type="eu", max_iter=3)
    assert got.w.dtype == np.float64  # ran on the CPU at X's dtype


def _entry_points():
    x = lowrank()
    return {
        "mur": lambda: mur(x, 5, max_iter=2),
        "mur_masked": lambda: mur_masked(x, x > 0.5, 5, max_iter=2),
        "hals": lambda: hals(x, 5, max_iter=2),
        "admm": lambda: admm(x, 5, max_iter=2),
        "topk_retrieval": lambda: ttopk.topk_retrieval(None, x[:4], x[:, :20].T, 3),
        "topk_streaming": lambda: ttopk.topk_streaming(x[:4, :20], x[:, :20].T, 60, 3),
        "NMF": lambda: tpunmf_torch.NMF(x, 5).factorize(max_iter=2),
    }


@pytest.mark.parametrize("entry", list(_entry_points()))
def test_numpy_input_without_a_card_raises(entry, monkeypatch):
    """Numpy means the card; with none, the port raises and does not run
    on the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
        _entry_points()[entry]()


def test_serving_inputs_follow_h():
    rng = np.random.default_rng(23)
    w = rng.random((4, 8)).astype(np.float32)
    h = rng.random((8, 300)).astype(np.float32)
    exclude = rng.random((4, 300)) < 0.2
    want = ttopk.topk_retrieval(None, t(w), t(h), 5, exclude=t(exclude))
    got = ttopk.topk_retrieval(None, w, t(h), 5, exclude=exclude)
    for g, e in zip(got, want):
        assert g.device.type == "cpu" and torch.equal(g, e)
    got = ttopk.topk_streaming(t(w), h, 300, 5, panel_cols=128)
    assert got[0].device.type == "cpu"
    assert torch.equal(got[1], ttopk.topk_scores_dense(t(w), t(h), 5)[1])
