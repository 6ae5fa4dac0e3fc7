"""tpunmf_torch's symmetric NMF against tpunmf's, on the CPU at float64.

From an explicit H (torch cannot draw jax.random's numbers) on a kNN graph
and on a dense similarity, beta 1/2 and 1; the seeded default init; the
errors with tpunmf's messages; checkpoints across the packages.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_results_match, lowrank, run_interrupted, t
from tpunmf.solvers import symnmf as jsymnmf
from tpunmf_torch.solvers import knn_graph, symnmf

FACTOR_RTOL = 1e-8
_KW = dict(min_iter=25, max_iter=25, tol1=0.0, tol2=0.0)
_X = lowrank(m=40, n=30)
_GRAPH = knn_graph(t(_X), 5).numpy()
_DENSE = _X.T @ _X / 40.0
_H0 = np.random.default_rng(9).random((30, 4))


@pytest.mark.parametrize("a", ["graph", "dense"])
@pytest.mark.parametrize("beta", [0.5, 1.0])
def test_symnmf_matches_tpunmf(a, beta):
    a = {"graph": _GRAPH, "dense": _DENSE}[a]
    want = jsymnmf(a, 4, beta=beta, h_init=_H0, **_KW)
    got = symnmf(t(a), 4, beta=beta, h_init=_H0, **_KW)
    assert got.i == 24
    assert_results_match(got, want, FACTOR_RTOL)
    np.testing.assert_array_equal(got.w, got.h.T)
    # the Gram form is ||A - H H^T||^2
    d = a - got.w @ got.h
    np.testing.assert_allclose(got.obj_history[-1], np.sum(d * d), rtol=1e-9)


def test_default_init_is_seeded_and_scaled():
    a = symnmf(t(_GRAPH), 4, min_iter=2, max_iter=2)
    b = symnmf(t(_GRAPH), 4, min_iter=2, max_iter=2, key=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    h0 = torch.rand((30, 4), generator=g, dtype=torch.float64) * np.sqrt(_GRAPH.mean() / 4)
    c = symnmf(t(_GRAPH), 4, min_iter=2, max_iter=2, h_init=h0)
    assert a.obj_history == b.obj_history == c.obj_history


@pytest.mark.parametrize("a,kw", [
    (np.ones((30, 29)), {}),
    (_GRAPH, dict(beta=0.0)),
    (_GRAPH, dict(beta=1.5)),
    (-_GRAPH, {}),
    (_GRAPH, dict(h_init=np.ones((30, 3)))),
], ids=["not_square", "beta_zero", "beta_above_one", "negative", "init_shape"])
def test_errors_are_tpunmf_s(a, kw):
    with pytest.raises(ValueError) as want:
        jsymnmf(a, 4, **kw)
    with pytest.raises(ValueError) as got:
        symnmf(t(a), 4, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("direction", ["tpunmf_to_port", "port_to_tpunmf"])
def test_checkpoint_crosses_between_packages(tmp_path, direction):
    kw = dict(_KW, h_init=_H0)
    want = jsymnmf(_GRAPH, 4, **kw)
    writer, reader = ((jsymnmf, symnmf) if direction == "tpunmf_to_port"
                      else (symnmf, jsymnmf))
    data = {jsymnmf: _GRAPH, symnmf: t(_GRAPH)}
    ck = str(tmp_path / "symnmf")
    run_interrupted(lambda **c: writer(data[writer], 4, **kw, **c), ck, 10, 2)
    got = reader(data[reader], 4, checkpoint_path=ck, checkpoint_every=10, resume=True, **kw)
    assert_results_match(got, want, FACTOR_RTOL)
