"""tpunmf_torch's experiments module against tpunmf's, on the CPU at float64.

``grid_search`` (MUR and ADMM, with the same saved file names),
``mur_lambda_grid`` (EU and KL: factors and objectives), the rank scan's
per-rank body fed ``tpunmf``'s own inits, the port's ``rank_scan`` on a
planted rank, ``run_param_file`` and ``corcondia`` on fixed CP factors.
"""
import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import TRACE_RTOL, assert_traces_match, lowrank, t
from tpunmf import experiments as jexp
from tpunmf.init import random_init as jrandom_init
from tpunmf_torch import experiments as texp
from tpunmf_torch.solvers import mur as tmur

_X = lowrank()
_RNG = np.random.default_rng(5)
_W0, _H0 = _RNG.random((60, 4)) + 0.1, _RNG.random((4, 48)) + 0.1


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


@pytest.mark.parametrize("method,extra", [
    ("mur", dict(distance_type="eu")),
    ("admm", dict(distance_type="kl", reg_h=(0.0, "l1n"))),
], ids=["mur", "admm"])
def test_grid_search_matches_tpunmf(method, extra, tmp_path):
    kw = dict(method=method, features=(3, 5), lambda_w=(0.0, 0.1), lambda_h=(0.05,),
              min_iter=6, max_iter=6, tol1=1e-9, tol2=1e-9,
              nndsvd_init=(True, "zero"), **extra)
    want = _quiet(jexp.grid_search, _X, save_dir=str(tmp_path / "jax"), **kw)
    got = _quiet(texp.grid_search, t(_X), save_dir=str(tmp_path / "port"), **kw)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.i == w.i and g.experiment == tuple(w.experiment)
        assert_traces_match(g.obj_history, w.obj_history)
    names = sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 4 and names == sorted(os.listdir(tmp_path / "jax"))
    if method == "admm":  # the lambdas become reg tuples of the given types
        assert all(":l1n" in n and ":nn" in n for n in names)


@pytest.mark.parametrize("distance", ["eu", "kl"])
def test_mur_lambda_grid_matches_tpunmf(distance):
    x = _X + 0.05 if distance == "kl" else _X
    kw = dict(lambda_w=(0.0, 0.1), lambda_h=(0.0, 0.05, 0.2), distance_type=distance,
              n_iter=12, w_init=_W0, h_init=_H0)
    combos, ws, hs, objs = jexp.mur_lambda_grid(x, 4, **kw)
    tcombos, tws, ths, tobjs = texp.mur_lambda_grid(t(x), 4, **kw)
    assert tcombos == combos and tobjs.shape == (6, 12) and tws.shape == (6, 60, 4)
    np.testing.assert_allclose(tobjs.numpy(), np.asarray(objs), rtol=TRACE_RTOL)
    np.testing.assert_allclose(tws.numpy(), np.asarray(ws), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(ths.numpy(), np.asarray(hs), rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("distance", ["eu", "kl"])
def test_mur_lambda_grid_matches_sequential_runs(distance):
    """Each combination is the port's own MUR run from the shared init."""
    x = _X + 0.05 if distance == "kl" else _X
    combos, ws, _, objs = texp.mur_lambda_grid(
        t(x), 4, lambda_w=(0.0, 0.1), lambda_h=(0.0, 0.05), distance_type=distance,
        n_iter=10, w_init=_W0, h_init=_H0)
    for b, (lw, lh) in enumerate(combos):
        ref = tmur(t(x), 4, distance_type=distance, lambda_w=lw, lambda_h=lh,
                   w_init=_W0, h_init=_H0, min_iter=10, max_iter=10, tol1=0.0,
                   tol2=0.0)
        np.testing.assert_allclose(objs[b].numpy(), ref.obj_history[1:], rtol=1e-9)
        np.testing.assert_allclose(ws[b].numpy(), ref.w, rtol=1e-9, atol=1e-14)


def test_mur_lambda_grid_random_init_and_refusals():
    combos, ws, _, objs = texp.mur_lambda_grid(t(_X), 3, lambda_w=(0.0, 0.2),
                                               n_iter=5, key=3)
    again = texp.mur_lambda_grid(t(_X), 3, lambda_w=(0.0, 0.2), n_iter=5, key=3)
    torch.testing.assert_close(again[3], objs, rtol=0, atol=0)
    assert bool(torch.all(objs[:, -1] <= objs[:, 0]))
    # over a mesh (a world of one here): tpunmf's sharded grid, and the
    # unsharded one, from the same init
    from tpunmf import parallel as jpar
    from tpunmf_torch import parallel as tpar

    kw = dict(lambda_w=(0.0, 0.2), n_iter=5, w_init=_W0[:, :3], h_init=_H0[:3])
    got = texp.mur_lambda_grid(t(_X), 3, mesh=tpar.build_mesh((1,), ("grid",),
                                                               device_type="cpu"),
                               grid_axis="grid", **kw)
    want = jexp.mur_lambda_grid(_X, 3, mesh=jpar.build_mesh((1,), ("grid",),
                                                            devices=jax.devices()[:1]),
                                grid_axis="grid", **kw)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-9)
    torch.testing.assert_close(got[3], texp.mur_lambda_grid(t(_X), 3, **kw)[3], rtol=0, atol=0)
    with pytest.raises(KeyError):
        texp.mur_lambda_grid(t(_X), 3, distance_type="is")
    with pytest.raises(ValueError, match="both"):
        texp.mur_lambda_grid(t(_X), 3, w_init=_W0[:, :3])


def _tpunmf_inits(x, k, n_seeds, seed=0):
    """The inits tpunmf's rank_scan draws for rank k (experiments.py:261)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), k), n_seeds)
    pairs = [jrandom_init(key, x.shape[0], x.shape[1], k, kind="abs_normal",
                          dtype=x.dtype) for key in keys]
    return (torch.from_numpy(np.stack([np.asarray(w) for w, _ in pairs])),
            torch.from_numpy(np.stack([np.asarray(h) for _, h in pairs])))


@pytest.mark.parametrize("distance", ["eu", "kl"])
@pytest.mark.parametrize("k", [2, 4])
def test_rank_scan_body_matches_tpunmf(distance, k):
    x = _X + 0.05 if distance == "kl" else _X
    want = jexp.rank_scan(x, ks=(k,), n_seeds=4, distance_type=distance, n_iter=20)[0]
    w0s, h0s = _tpunmf_inits(x, k, 4)
    disp, obj = texp.rank_scan_body(t(x), w0s, h0s, distance, 20)
    np.testing.assert_allclose(disp, want["dispersion"], rtol=1e-12)
    np.testing.assert_allclose(obj, want["mean_final_obj"], rtol=TRACE_RTOL)


def test_rank_scan_finds_true_rank(rng):
    """The port's rank_scan, as tests/test_cli.py:135-152 holds tpunmf's."""
    m, n, k_true = 60, 48, 3
    h = np.zeros((k_true, n))
    for j in range(n):
        h[j % k_true, j] = 1.0
    h += 0.02 * rng.random((k_true, n))
    w = rng.random((m, k_true)) + 0.1
    x = t(w @ h)
    res = texp.rank_scan(x, ks=(2, 3, 5), n_seeds=6, n_iter=150)
    by_k = {r["k"]: r["dispersion"] for r in res}
    assert by_k[3] > 0.95
    assert by_k[3] >= by_k[5] - 1e-9
    assert all(0.0 <= r["dispersion"] <= 1.0 + 1e-9 for r in res)
    # a rank's draws come from (key, k) alone: scanning it alone gives the same
    alone = texp.rank_scan(x, ks=(5,), n_seeds=6, n_iter=150)[0]
    assert alone == res[2]
    assert texp.rank_scan(x, ks=(5,), n_seeds=6, n_iter=150, key=1)[0] != alone


def test_run_param_file(tmp_path, monkeypatch):
    (tmp_path / "torch_grid_params.py").write_text(
        "method_params = dict(distance_type='eu', min_iter=4, max_iter=4,\n"
        "                     nndsvd_init=(True, 'zero'))\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    got = _quiet(texp.run_param_file, t(_X), 4, "torch_grid_params")
    want = _quiet(jexp.run_param_file, _X, 4, "torch_grid_params")
    assert got.i == want.i == 3
    assert_traces_match(got.obj_history, want.obj_history)


def _cp_tensor(shape, k, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    fs = [rng.random((d, k)) + 0.1 for d in shape]
    x = np.einsum("ir,jr,lr->ijl", *fs) + noise * rng.random(shape)
    return x, fs


@pytest.mark.parametrize("rank_used", [3, 5])
def test_corcondia_matches_tpunmf(rank_used):
    x, fs = _cp_tensor((12, 10, 8), 3, seed=4, noise=0.01)
    if rank_used != 3:  # an over-fit model: two more random components
        extra = np.random.default_rng(9)
        fs = [np.hstack([f, extra.random((f.shape[0], 2))]) for f in fs]
    want = jexp.corcondia(x, fs)
    got = texp.corcondia(t(x), [t(f) for f in fs])
    np.testing.assert_allclose(got, want, rtol=1e-9)
    if rank_used == 3:
        assert got > 99.0
    # a 2-way "tensor" (matrix) works too
    x2 = fs[0] @ fs[1].T
    np.testing.assert_allclose(texp.corcondia(t(x2), [t(fs[0]), t(fs[1])]),
                               jexp.corcondia(x2, fs[:2]), rtol=1e-9)
