"""tpunmf_torch's facade, files, errors, data, and its independence of JAX."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpunmf
import tpunmf_torch
from _torch_parity import assert_results_match, lowrank, one_rank_meshes, t
from tpunmf.data import synthetic as jsynthetic
from tpunmf_torch.data import synthetic as tsynthetic
from tpunmf_torch.io import convert

REPO = Path(__file__).resolve().parents[1]


def _fit(pkg, data, **kw):
    model = pkg.NMF(data, 5)
    model.factorize(method="mur", distance_type="eu", max_iter=8, **kw)
    return model


@pytest.mark.parametrize("kw", [
    dict(nndsvd_init=(True, "zero")),
    dict(nndsvd_init=(True, "mean"), lambda_w=0.5),
    dict(distance_type="kl"),
])
def test_default_save_name_is_tpunmf_s(kw):
    kw = {"distance_type": "eu", **kw}
    jm = tpunmf.NMF(lowrank(), 5)
    jm.factorize(method="mur", max_iter=4, **kw)
    tm = tpunmf_torch.NMF(t(lowrank()), 5)
    tm.factorize(method="mur", max_iter=4, **kw)
    assert tm.default_save_name() == jm.default_save_name()


def test_port_loads_tpunmf_files_and_back(tmp_path):
    jm = _fit(tpunmf, lowrank(), nndsvd_init=(True, "zero"))
    jpath = jm.save_factorization(save_dir=str(tmp_path / "jax"))
    loaded = tpunmf_torch.NMF.load_factorization(jpath)
    np.testing.assert_array_equal(loaded.w, np.asarray(jm.w))
    np.testing.assert_array_equal(loaded.h, np.asarray(jm.h))
    assert loaded.results.i == jm.results.i
    np.testing.assert_array_equal(loaded.results.obj_history, jm.results.obj_history)
    assert loaded.default_save_name() == jm.default_save_name()

    tm = _fit(tpunmf_torch, t(lowrank()), nndsvd_init=(True, "zero"))
    tpath = tm.save_factorization(save_dir=str(tmp_path / "torch"))
    assert os.path.basename(tpath) == os.path.basename(jpath)
    back = tpunmf.NMF.load_factorization(tpath)
    np.testing.assert_array_equal(back.w, tm.w)
    assert back.results.experiment._asdict() == tm.results.experiment._asdict()
    with np.load(tpath, allow_pickle=True) as f, np.load(jpath, allow_pickle=True) as g:
        assert sorted(f.files) == sorted(g.files)
        assert all(f[k].dtype == g[k].dtype for k in f.files)


def test_facade_properties_and_save_guard(tmp_path):
    model = tpunmf_torch.NMF(t(lowrank()), 5)
    assert model.w is None and model.h is None
    with pytest.raises(RuntimeError):
        model.save_factorization(save_dir=str(tmp_path))
    res = model.factorize(max_iter=3)  # defaults: mur, KL, random init
    assert res.experiment.distance_type == "kl"
    assert model.w.shape == (60, 5) and model.h.shape == (5, 48)
    path = model.save_factorization(save_dir=str(tmp_path))
    assert path.endswith("_random.npz")


@pytest.mark.parametrize("method", ["anls", "admm", "ao_admm", "hals", "ntf"])
def test_unported_methods_raise(method, tmp_path):
    # every method of the list is ported (the id predates the ports); anls,
    # admm and ao_admm's checkpoints too: the run saves its state
    if method in ("anls", "admm", "ao_admm"):
        ck = str(tmp_path / "ckpt")
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method=method, max_iter=3,
                                                    checkpoint_path=ck)
        assert os.path.exists(ck + ".npz")
        return
    if method == "hals":
        # hals and its multilevel= warm start are ported: tpunmf's run
        kw = dict(multilevel={"levels": 2}, min_iter=3, max_iter=3, tol1=0.0, tol2=0.0)
        got = tpunmf_torch.NMF(t(lowrank()), 5).factorize(method=method, **kw)
        want = tpunmf.NMF(lowrank(), 5).factorize(method=method, **kw)
        assert got.i == want.i == 2
        np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=1e-10)
        return
    # ntf is ported, the last method of tpunmf's list: tpunmf's run on a 3-way X
    from tpunmf_torch.api import _METHODS, _PORTED

    assert _PORTED == _METHODS
    x = lowrank().reshape(60, 6, 8)
    init = [np.random.default_rng(d).random((n, 5)) + 0.1 for d, n in enumerate(x.shape)]
    kw = dict(factors_init=init, min_iter=4, max_iter=4, tol1=0.0, tol2=0.0)
    got = tpunmf_torch.NMF(t(x), 5).factorize(method=method, **kw)
    want = tpunmf.NMF(x, 5).factorize(method=method, **kw)
    assert got.i == want.i == 3
    np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=1e-10)


def test_unknown_method_fails_as_tpunmf_does():
    with pytest.raises(Exception, match="Method not known") as got:
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="svd")
    with pytest.raises(Exception) as want:
        tpunmf.NMF(lowrank(), 5).factorize(method="svd")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("option", ["schedule", "beta", "mask", "multilevel", "mesh"])
def test_unported_routes_raise(option):
    if option == "beta":
        # beta= is ported: the beta-divergence MUR, beta=1 tagged as KL
        res = tpunmf_torch.NMF(t(lowrank()), 5).factorize(
            method="mur", beta=1, min_iter=3, max_iter=3)
        assert res.experiment.distance_type == "kl" and res.i == 2
        return
    if option == "mask":
        # mask= is ported; with an unported route it fails tpunmf's
        # mutual-exclusion check first (tpunmf/api.py:122-129)
        with pytest.raises(ValueError, match="beta and mask are mutually exclusive"):
            tpunmf_torch.NMF(t(lowrank()), 5).factorize(
                method="mur", mask=np.ones((60, 48)), beta=1)
        return
    if option == "multilevel":
        # multilevel= is ported: the warm start rides mur as in tpunmf
        kw = dict(multilevel=True, min_iter=3, max_iter=3, tol1=0.0, tol2=0.0,
                  nndsvd_init=(True, "zero"))
        got = tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="mur", **kw)
        want = tpunmf.NMF(lowrank(), 5).factorize(method="mur", **kw)
        assert got.i == want.i == 2
        np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=1e-10)
        return
    # schedule= and mesh= are ported (tpunmf_torch.parallel): a schedule
    # without a mesh fails as tpunmf's does (tpunmf/api.py:130-139), and on
    # a one-rank CPU mesh each runs as tpunmf's does on a one-device mesh
    kw = dict(schedule="rank") if option == "schedule" else dict(schedule="ulysses",
                                                                  mesh=None)
    with pytest.raises(ValueError, match="requires a mesh") as got:
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="mur", **kw)
    with pytest.raises(ValueError) as want:
        tpunmf.NMF(lowrank(), 5).factorize(method="mur", **kw)
    assert str(got.value) == str(want.value)
    tmesh, jmesh = one_rank_meshes()
    run = dict(distance_type="kl", nndsvd_init=(True, "zero"), min_iter=3, max_iter=50,
               tol1=0.0, tol2=0.1)
    if option == "schedule":
        got = tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="mur", schedule="ulysses",
                                                          mesh=tmesh, **run)
        want = tpunmf.NMF(lowrank(), 5).factorize(method="mur", schedule="ulysses",
                                                  mesh=jmesh, **run)
    else:
        got = tpunmf_torch.NMF(t(lowrank()), 5, mesh=tmesh).factorize(method="mur", **run)
        want = tpunmf.NMF(lowrank(), 5, mesh=jmesh).factorize(method="mur", **run)
    assert got.i < 49
    assert_results_match(got, want, rtol=1e-9)


@pytest.mark.parametrize("kw,exc", [
    # a checkpoint of another configuration (max_iter 5) is refused
    (dict(checkpoint_path="ckpt"), ValueError),
    # the id predates the port of multilevel=, which raised
    # NotImplementedError; levels=0 is an error tpunmf raises too
    pytest.param(dict(multilevel={"levels": 0}), ValueError,
                 id="kw1-NotImplementedError"),
    (dict(w_init=np.ones((60, 5))), ValueError),
    (dict(distance_type="is"), KeyError),
    (dict(objective_every=0), ValueError),
])
def test_solver_errors(kw, exc, tmp_path):
    if "checkpoint_path" in kw:
        kw = dict(checkpoint_path=str(tmp_path / "ckpt"), resume=True)
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="mur", max_iter=5, **kw)
    with pytest.raises(exc):
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="mur", max_iter=3, **kw)


def test_mesh_is_not_ported():
    """A mesh given at construction is kept, as tpunmf keeps it
    (tpunmf/api.py:46-56): MUR runs over it, by default or with a
    schedule, and so do HALS, ANLS, ADMM, AO-ADMM and MUR with mask=, each
    giving tpunmf's results; the data stay global (each rank keeps its
    block inside the drivers).  What waits for the next slice raises,
    naming ROADMAP item 9: other methods, multilevel=, beta= and MUR's
    objective=."""
    tmesh, jmesh = one_rank_meshes()
    got_model = tpunmf_torch.NMF(t(lowrank()), 5, mesh=tmesh)
    want_model = tpunmf.NMF(lowrank(), 5, mesh=jmesh)
    assert got_model.mesh is tmesh and want_model.mesh is jmesh
    kw = dict(distance_type="eu", nndsvd_init=(True, "zero"), max_iter=6)
    for schedule in (None, "rank"):
        got = got_model.factorize(method="mur", schedule=schedule, **kw)
        want = want_model.factorize(method="mur", schedule=schedule, **kw)
        assert_results_match(got, want, rtol=1e-9)
        np.testing.assert_allclose(got_model.w, np.asarray(want_model.w), rtol=1e-9)
    mask = np.random.default_rng(4).random((60, 48)) < 0.8
    for method, extra in (("hals", {}), ("anls", {}), ("admm", {}), ("ao_admm", {}),
                          ("mur", {"mask": mask, "distance_type": "eu"})):
        kw = dict(nndsvd_init=(True, "zero"), min_iter=2, max_iter=6, **extra)
        got = got_model.factorize(method=method, **kw)
        want = want_model.factorize(method=method, **kw)
        assert_results_match(got, want, rtol=1e-9)
    for method, extra in (("semi_nmf", {}), ("robust", {}), ("mur", {"multilevel": True}),
                          ("mur", {"beta": 1})):
        with pytest.raises(NotImplementedError, match="item 9"):
            got_model.factorize(method=method, max_iter=2, **extra)
    with pytest.raises(NotImplementedError, match="objective.*item 9"):
        got_model.factorize(method="mur", objective="gram", max_iter=2)


def test_synthetic_data_is_tpunmf_s():
    np.testing.assert_array_equal(tsynthetic.lowrank_dense(30, 20, 4, seed=3),
                                  jsynthetic.lowrank_dense(30, 20, 4, seed=3))
    np.testing.assert_array_equal(
        tsynthetic.tfidf_like(200, 40, n_topics=5, seed=1),
        jsynthetic.tfidf_like(200, 40, n_topics=5, seed=1))


def test_convert_round_trips_results():
    jres = tpunmf.NMF(lowrank(), 5).factorize(method="mur", max_iter=3)
    tres = convert.results_to_torch(jres, dtype=torch.float64)
    assert isinstance(tres.w, torch.Tensor) and tres.w.dtype == torch.float64
    back = convert.results_to_numpy(tres)
    np.testing.assert_array_equal(back.w, np.asarray(jres.w))
    assert back.i == jres.i and back.experiment == jres.experiment
    bf = convert.to_tensor(np.ones((2, 2), np.float32), dtype=torch.bfloat16)
    assert convert.results_to_numpy(tres._replace(w=bf)).w.dtype == np.float32


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_tpunmf():
    files = [p for p in sorted((REPO / "tpunmf_torch").rglob("*.py"))
             if "_build" not in p.parts]  # the kernel build dir is not source
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "tpunmf"), f"{path}: imports {name}"


def test_chip_smoke_fails_without_a_card():
    """No CUDA here: chip_smoke.py exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode != 0
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    assert '"ok"' not in last
    with pytest.raises(json.JSONDecodeError):
        json.loads(last)
