"""tpunmf_torch's graph-regularized NMF and kNN graph against tpunmf's, on
the CPU at float64.

``knn_graph`` in both modes, with sigma given and left at None, and its
errors; ``gnmf`` from explicit inits, NNDSVD and the seeded random init,
with a dense, a tensor and a scipy sparse adjacency, lambda_g 0 and 1, on
mixed-sign X (elevated as tpunmf elevates it), the objective kernel's
wiring, and its errors.  Checkpoints across the packages are in
test_torch_checkpoint.py.
"""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_parity import assert_results_match, lowrank, t
from tpunmf.solvers import gnmf as jgnmf
from tpunmf.solvers import knn_graph as jknn_graph
from tpunmf_torch.solvers import gnmf, knn_graph

gnmf_module = importlib.import_module("tpunmf_torch.solvers.gnmf")

FACTOR_RTOL = 1e-8
_KW = dict(min_iter=25, max_iter=25, tol1=0.0, tol2=0.0)
_X = lowrank(m=40, n=30)


@pytest.mark.parametrize("mode,sigma", [("heat", None), ("heat", 2.0), ("binary", None)])
@pytest.mark.parametrize("n_neighbors", [1, 5])
def test_knn_graph_is_tpunmf_s(mode, sigma, n_neighbors):
    want = np.asarray(jknn_graph(_X, n_neighbors, mode=mode, sigma=sigma))
    got = knn_graph(t(_X), n_neighbors, mode=mode, sigma=sigma)
    assert got.dtype == torch.float64 and got.shape == (30, 30)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-14)
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    assert torch.equal(got, got.T) and not got.diagonal().any()


def test_knn_graph_keeps_ties():
    # columns 0 and 1 are the same point, 2 and 3 at the same distance from it
    x = np.zeros((2, 5))
    x[:, 2] = [1.0, 0.0]
    x[:, 3] = [0.0, 1.0]
    x[:, 4] = [5.0, 5.0]
    want = np.asarray(jknn_graph(x, 2, mode="binary"))
    got = knn_graph(t(x), 2, mode="binary").numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 2] == got[0, 3] == 1.0


@pytest.mark.parametrize("kw,message", [
    (dict(n_neighbors=0), "need 0 < n_neighbors < n"),
    (dict(n_neighbors=30), "need 0 < n_neighbors < n"),
    (dict(mode="cosine"), "mode must be 'heat' or 'binary'"),
])
def test_knn_graph_errors_are_tpunmf_s(kw, message):
    with pytest.raises(ValueError, match=message):
        jknn_graph(_X, **kw)
    with pytest.raises(ValueError, match=message):
        knn_graph(t(_X), **kw)


_A = np.array(jknn_graph(_X, 5))


@pytest.mark.parametrize("case", ["inits", "inits_lambda0", "nndsvd", "random",
                                  "sparse_adjacency", "tensor_adjacency", "mixed_sign"])
def test_gnmf_matches_tpunmf(case):
    rng = np.random.default_rng(7)
    x = _X - 0.5 if case == "mixed_sign" else _X
    a = {"sparse_adjacency": sp.csr_matrix(_A)}.get(case, _A)
    kw = dict(_KW, lambda_g=0.0 if case == "inits_lambda0" else 1.0)
    if case == "nndsvd":
        kw["nndsvd_init"] = (True, "mean")
    elif case == "random":
        # torch's draws are not jax.random's: the same draw handed to both
        g = torch.Generator().manual_seed(0)
        w0 = torch.randn((40, 4), generator=g, dtype=torch.float64).abs()
        h0 = torch.randn((4, 30), generator=g, dtype=torch.float64).abs()
        got = gnmf(t(x), 4, t(a), **kw)
        assert_results_match(got, gnmf(t(x), 4, t(a), w_init=w0, h_init=h0, **kw), 0)
        kw.update(w_init=w0.numpy(), h_init=h0.numpy())
    else:
        kw.update(w_init=rng.random((40, 4)) + 0.1, h_init=rng.random((4, 30)) + 0.1)
    want = jgnmf(x, 4, a, **kw)
    got = gnmf(t(x), 4, t(a) if case == "tensor_adjacency" else a, **kw)
    assert got.i == 24
    assert_results_match(got, want, FACTOR_RTOL)


def test_gnmf_objective_kernel_is_called_once_an_iteration(monkeypatch):
    """Float32 X with use_pallas: the data term goes through eu_residual_obj
    (its plain version on the CPU), once for obj[0] and once an iteration,
    and the factors are the plain route's bits."""
    calls = []
    x = t(_X).float()
    monkeypatch.setattr(gnmf_module, "eu_residual_obj",
                        lambda *a: calls.append(1) or gnmf_module.eu_residual_obj_ref(*a))
    got = gnmf(x, 4, t(_A).float(), use_pallas=True, min_iter=5, max_iter=5)
    plain = gnmf(x, 4, t(_A).float(), use_pallas=False, min_iter=5, max_iter=5)
    assert len(calls) == 6
    np.testing.assert_array_equal(got.w, plain.w)
    np.testing.assert_array_equal(got.obj_history, plain.obj_history)


@pytest.mark.parametrize("kw", [dict(adjacency=np.ones((29, 29))), dict(lambda_g=-1.0),
                                dict(w_init=np.ones((40, 4)))],
                         ids=["adjacency_shape", "negative_lambda", "one_init"])
def test_gnmf_errors_are_tpunmf_s(kw):
    a = kw.pop("adjacency", _A)
    with pytest.raises(ValueError) as want:
        jgnmf(_X, 4, a, **kw)
    with pytest.raises(ValueError) as got:
        gnmf(t(_X), 4, a, **kw)
    assert str(got.value) == str(want.value)
