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
from _torch_parity import lowrank, t
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
def test_unported_methods_raise(method):
    # hals is ported, its multilevel= warm start is not
    kw = {"multilevel": {"levels": 2}} if method == "hals" else {}
    with pytest.raises(NotImplementedError, match="not ported"):
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method=method, **kw)


def test_unknown_method_fails_as_tpunmf_does():
    with pytest.raises(Exception, match="Method not known") as got:
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="svd")
    with pytest.raises(Exception) as want:
        tpunmf.NMF(lowrank(), 5).factorize(method="svd")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("option", ["schedule", "beta", "mask", "multilevel", "mesh"])
def test_unported_routes_raise(option):
    if option == "mask":
        # mask= is ported; with an unported route it fails tpunmf's
        # mutual-exclusion check first (tpunmf/api.py:122-129)
        with pytest.raises(ValueError, match="beta and mask are mutually exclusive"):
            tpunmf_torch.NMF(t(lowrank()), 5).factorize(
                method="mur", mask=np.ones((60, 48)), beta=1)
        return
    with pytest.raises(NotImplementedError, match=option):
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="mur", **{option: 1})


@pytest.mark.parametrize("kw,exc", [
    (dict(checkpoint_path="ckpt"), NotImplementedError),
    (dict(multilevel={"levels": 2}), NotImplementedError),
    (dict(w_init=np.ones((60, 5))), ValueError),
    (dict(distance_type="is"), KeyError),
    (dict(objective_every=0), ValueError),
])
def test_solver_errors(kw, exc):
    with pytest.raises(exc):
        tpunmf_torch.NMF(t(lowrank()), 5).factorize(method="mur", max_iter=3, **kw)


def test_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="mesh"):
        tpunmf_torch.NMF(t(lowrank()), 5, mesh=object())


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
