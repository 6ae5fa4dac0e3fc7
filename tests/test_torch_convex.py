"""tpunmf_torch's convex NMF against tpunmf's, on the CPU at float64.

Mixed-sign X (column-centred) and non-negative X from explicit inits
(torch cannot draw jax.random's numbers) at two shapes; the Gram-form
objective against the direct one; the seeded default init; the errors
with tpunmf's messages; checkpoints across the packages.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_results_match, lowrank, run_interrupted, t
from tpunmf.solvers import convex_nmf as jconvex_nmf
from tpunmf_torch.solvers import convex_nmf

FACTOR_RTOL = 1e-8
_KW = dict(min_iter=25, max_iter=25, tol1=0.0, tol2=0.0)


def _problem(m, n, centred, k=4, seed=5):
    x = lowrank(m=m, n=n)
    if centred:
        x = x - x.mean(axis=0)
    rng = np.random.default_rng(seed)
    return x, rng.random((n, k)) + 0.1, rng.random((n, k)) + 0.1


@pytest.mark.parametrize("shape", [(40, 30), (25, 60)])
@pytest.mark.parametrize("centred", [True, False])
def test_convex_nmf_matches_tpunmf(shape, centred):
    x, w0, g0 = _problem(*shape, centred)
    assert (x.min() < 0) == centred
    want = jconvex_nmf(x, 4, w_init=w0, g_init=g0, **_KW)
    got = convex_nmf(t(x), 4, w_init=w0, g_init=g0, **_KW)
    assert got.i == 24 and got.w.shape == (shape[0], 4) and got.h.shape == (4, shape[1])
    assert_results_match(got, want, FACTOR_RTOL)
    # the Gram form is ||X - (X W) G^T||^2, which the basis and G^T give
    d = x - got.w @ got.h
    np.testing.assert_allclose(got.obj_history[-1], np.sum(d * d), rtol=1e-9)


def test_default_init_is_seeded():
    x, _, _ = _problem(40, 30, True)
    a = convex_nmf(t(x), 4, min_iter=2, max_iter=2)
    b = convex_nmf(t(x), 4, min_iter=2, max_iter=2, key=0)
    c = convex_nmf(t(x), 4, min_iter=2, max_iter=2, key=3)
    assert a.obj_history == b.obj_history != c.obj_history
    g = torch.Generator().manual_seed(0)
    g0 = torch.randn((30, 4), generator=g, dtype=torch.float64).abs() + 0.2
    w0 = g0 / (g0.sum(dim=0, keepdim=True) + 1e-9)
    d = convex_nmf(t(x), 4, min_iter=2, max_iter=2, w_init=w0, g_init=g0)
    assert a.obj_history == d.obj_history


@pytest.mark.parametrize("kw", [dict(k=31), dict(k=0), dict(w_init=True),
                                dict(w_init=True, g_init=True, bad_shape=True)],
                         ids=["k_above_n", "k_zero", "one_init", "init_shape"])
def test_errors_are_tpunmf_s(kw):
    x, w0, g0 = _problem(40, 30, True)
    k = kw.get("k", 4)
    args = {}
    if kw.get("w_init"):
        args["w_init"] = w0[:, :3] if kw.get("bad_shape") else w0
    if kw.get("g_init"):
        args["g_init"] = g0
    with pytest.raises(ValueError) as want:
        jconvex_nmf(x, k, **args)
    with pytest.raises(ValueError) as got:
        convex_nmf(t(x), k, **args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("direction", ["tpunmf_to_port", "port_to_tpunmf"])
def test_checkpoint_crosses_between_packages(tmp_path, direction):
    x, w0, g0 = _problem(40, 30, True)
    kw = dict(_KW, w_init=w0, g_init=g0)
    want = jconvex_nmf(x, 4, **kw)
    writer, reader = ((jconvex_nmf, convex_nmf) if direction == "tpunmf_to_port"
                      else (convex_nmf, jconvex_nmf))
    data = {jconvex_nmf: x, convex_nmf: t(x)}
    ck = str(tmp_path / "convex")
    run_interrupted(lambda **c: writer(data[writer], 4, **kw, **c), ck, 10, 2)
    got = reader(data[reader], 4, checkpoint_path=ck, checkpoint_every=10, resume=True, **kw)
    assert_results_match(got, want, FACTOR_RTOL)
