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
from _torch_parity import assert_results_match, lowrank, one_rank_meshes, run_interrupted, t
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
    (tpunmf/api.py:46-56), and every method runs over it: MUR by default,
    with a schedule, mask=, beta=, multilevel= and its objective
    keywords, HALS, ANLS, ADMM, AO-ADMM, semi-NMF, ONMF, robust NMF and
    ntf, each giving tpunmf's results on its one-device mesh (the id
    predates the ports: these raised until the mesh drivers came); the
    data stay global (each rank keeps its block inside the drivers)."""
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
                          ("mur", {"mask": mask, "distance_type": "eu"}),
                          ("semi_nmf", {}), ("onmf", {}), ("onmf", {"orthogonal": "w"}),
                          ("robust", {}), ("mur", {"multilevel": True}),
                          ("hals", {"multilevel": {"levels": 1, "axis": 0}}),
                          ("mur", {"beta": 1}), ("mur", {"beta": 0.5}),
                          ("mur", {"objective": "gram", "distance_type": "eu"}),
                          ("mur", {"objective": "lagged", "objective_every": 2})):
        kw = dict(nndsvd_init=(True, "zero"), min_iter=2, max_iter=6, **extra)
        if method == "semi_nmf":  # mixed-sign X; the random init is torch's or JAX's own
            kw = dict(min_iter=2, max_iter=6, h_init=np.random.default_rng(5).random((5, 48)))
        data = lowrank() - 0.5 if method == "semi_nmf" else lowrank()
        got = tpunmf_torch.NMF(t(data), 5, mesh=tmesh).factorize(method=method, **kw)
        want = tpunmf.NMF(data, 5, mesh=jmesh).factorize(method=method, **kw)
        assert_results_match(got, want, rtol=1e-9)
    # data_dtype= stores X in bf16 as one device does (tpunmf's takes a JAX dtype)
    kw = dict(distance_type="eu", data_dtype=torch.bfloat16, nndsvd_init=(True, "zero"),
              max_iter=6, save_dir="unused", verbose=True)
    got = tpunmf_torch.NMF(t(lowrank()), 5, mesh=tmesh).factorize(method="mur", **kw)
    want = tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="mur", **kw)
    assert_results_match(got, want, rtol=0)
    x = lowrank().reshape(60, 6, 8)
    init = [np.random.default_rng(d).random((n, 5)) + 0.1 for d, n in enumerate(x.shape)]
    kw = dict(factors_init=init, min_iter=4, max_iter=4, tol1=0.0, tol2=0.0)
    got = tpunmf_torch.NMF(t(x), 5, mesh=tmesh).factorize(method="ntf", **kw)
    want = tpunmf.NMF(x, 5, mesh=jmesh).factorize(method="ntf", **kw)
    assert got.i == want.i == 3
    np.testing.assert_allclose(got.obj_history, want.obj_history, rtol=1e-10)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-12)
    assert "item 9" not in Path(tpunmf_torch.api.__file__).read_text()


# every mesh driver through the facade on a (1, 1) mesh: (method, options)
_MESH_DRIVERS = {
    "mur_eu": ("mur", dict(distance_type="eu")),
    "mur_kl": ("mur", dict(distance_type="kl")),
    "mur_masked": ("mur", dict(distance_type="eu", mask=True)),
    "mur_beta": ("mur", dict(beta=0.5)),
    "hals": ("hals", dict()),
    "anls": ("anls", dict()),
    "admm_kl": ("admm", dict(distance_type="kl")),
    "ao_admm": ("ao_admm", dict()),
    "semi_nmf": ("semi_nmf", dict()),
    "onmf": ("onmf", dict()),
    "robust": ("robust", dict()),
    "ntf": ("ntf", dict()),
}


def _driver_run(name, mesh, **kw):
    method, options = _MESH_DRIVERS[name]
    rng = np.random.default_rng(11)
    x = lowrank()
    kw = dict(options, min_iter=9, max_iter=9, tol1=0.0, tol2=0.0, **kw)
    if kw.pop("mask", False):
        kw["mask"] = t(rng.random(x.shape) < 0.8)
    if method == "ntf":
        x = x.reshape(60, 6, 8)
        kw["factors_init"] = [rng.random((n, 5)) + 0.1 for n in x.shape]
    elif method == "semi_nmf":
        x = x - 0.5
        kw["h_init"] = rng.random((5, 48))
    else:
        kw.update(w_init=rng.random((60, 5)) + 0.1, h_init=rng.random((5, 48)) + 0.1)
    return tpunmf_torch.NMF(t(x), 5, mesh=mesh).factorize(method=method, **kw)


def _fields(res):
    out = [np.asarray(res.obj_history)]
    return out + ([np.asarray(f) for f in res.factors] if hasattr(res, "factors")
                  else [res.w, res.h])


@pytest.mark.parametrize("backend", ["npz", "dcp"])
@pytest.mark.parametrize("name", list(_MESH_DRIVERS))
def test_a_mesh_run_resumes_bit_for_bit(name, backend, tmp_path):
    """Each mesh driver, in blocks of 3 with checkpoints, stopped after two
    blocks and resumed, gives the uninterrupted run's bits."""
    tmesh, _ = one_rank_meshes((1, 1), ("rows", "cols"))
    full = _driver_run(name, tmesh)
    path = str(tmp_path / "ck")
    run_interrupted(lambda **kw: _driver_run(name, tmesh, **kw), path, 3, 2,
                    checkpoint_backend=backend)
    seen = []
    resumed = _driver_run(name, tmesh, checkpoint_path=path, checkpoint_every=3, resume=True,
                          checkpoint_backend=backend, on_block_end=lambda c: seen.append(c.i))
    assert seen == [9]
    assert resumed.i == full.i == 8
    for a, b in zip(_fields(resumed), _fields(full)):
        np.testing.assert_array_equal(a, b)


def test_mesh_checkpoints_cross_packages_and_meshes(tmp_path):
    """HALS's checkpoint written on the port's (1, 1) mesh resumes in
    tpunmf's one-device hals, and one written by tpunmf's mesh run resumes
    in the port's (1,) mesh driver: each gives its uninterrupted run."""
    tmesh, jmesh = one_rank_meshes((1, 1), ("rows", "cols"))
    x = lowrank()
    rng = np.random.default_rng(12)
    kw = dict(w_init=rng.random((60, 5)) + 0.1, h_init=rng.random((5, 48)) + 0.1, min_iter=8,
              max_iter=8, tol1=0.0, tol2=0.0)
    from tpunmf.solvers import hals as jhals

    want = jhals(x, 5, **kw)
    path = str(tmp_path / "port")
    run_interrupted(lambda **k: tpunmf_torch.NMF(t(x), 5, mesh=tmesh).factorize(
        method="hals", **k, **kw), path, 4, 1)
    got = jhals(x, 5, checkpoint_path=path, checkpoint_every=4, resume=True, **kw)
    assert_results_match(got, want, rtol=1e-10)
    path = str(tmp_path / "jax")
    run_interrupted(lambda **k: tpunmf.NMF(x, 5, mesh=jmesh).factorize(method="hals", **k, **kw),
                    path, 4, 1)
    tmesh1, _ = one_rank_meshes()
    got = tpunmf_torch.NMF(t(x), 5, mesh=tmesh1).factorize(
        method="hals", checkpoint_path=path, checkpoint_every=4, resume=True, **kw)
    assert_results_match(got, want, rtol=1e-10)


def test_dcp_backend_roundtrip(tmp_path):
    """The DCP backend restores the carry the .npz backend restores
    (tests/test_checkpoint.py::test_orbax_backend_roundtrip's check), and
    refuses another configuration."""
    from tpunmf_torch.io import checkpoint_exists_dcp, load_state_dcp, save_state_dcp
    from tpunmf_torch.solvers.common import init_carry

    x = t(lowrank())
    w, h = x[:, :4], x[:4, :].T.contiguous().T  # h column-major
    carry = init_carry(torch.tensor(1.25, dtype=torch.float64), 20, (w, h))
    path = str(tmp_path / "state")
    assert not checkpoint_exists_dcp(path)
    save_state_dcp(path, carry, meta="cfg-1")
    assert checkpoint_exists_dcp(path)
    restored = load_state_dcp(path, carry, expected_meta="cfg-1")
    np.testing.assert_array_equal(restored.inner[0].numpy(), w.numpy())
    np.testing.assert_array_equal(restored.inner[1].numpy(), h.numpy())
    assert restored.inner[1].stride() == h.stride()
    np.testing.assert_array_equal(restored.obj_buf.numpy(), carry.obj_buf.numpy())
    assert restored.i == 0 and restored.converged is False
    with pytest.raises(ValueError, match="mismatch"):
        load_state_dcp(path, carry, expected_meta="cfg-2")
    with pytest.raises(ValueError, match="shape"):
        load_state_dcp(path, carry._replace(inner=(w[:30], h)), expected_meta="cfg-1")


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
