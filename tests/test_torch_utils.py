"""tpunmf_torch.utils (metrics, profiling) and tpunmf_torch.data's file
loaders, on the CPU: the metrics logger's records and JSON lines, a trace
file, the determinism check, the NaN check, the kernel build directory, and
each loader against tpunmf's on files the test writes itself."""
import io
import json

import numpy as np
import pytest
import torch

from _torch_parity import lowrank, t
from tpunmf.data import loaders as jloaders
from tpunmf_torch import data as tdata
from tpunmf_torch.ops import _build
from tpunmf_torch.solvers import hals, mur
from tpunmf_torch.utils import (MetricsLogger, debug_nans, determinism_check,
                                enable_compilation_cache, named_scope,
                                objective_trace_stream, trace)

_KW = dict(distance_type="eu", min_iter=5, max_iter=40, tol1=1e-12, tol2=1e-12,
           nndsvd_init=(True, "zero"))


def test_metrics_logger_collects():
    logger = MetricsLogger(flops_per_iter=6 * 60 * 48 * 5)
    res = mur(t(lowrank()), 5, block_size=10, on_block_end=logger, **_KW)
    assert [r["iteration"] for r in logger.records] == [10, 20, 30, 40]
    assert logger.records[-1]["objective"] == res.obj_history[-1]
    assert all(r["gflops"] > 0 for r in logger.records)
    s = logger.summary()
    assert s["iterations"] == 40 and s["final_objective"] > 0
    assert s["mean_iters_per_sec"] > 0


def test_metrics_logger_stream_jsonl_and_trace_stream():
    buf, lines = io.StringIO(), io.StringIO()
    logger = MetricsLogger(stream=buf)
    echo = objective_trace_stream(lines)
    mur(t(lowrank()), 5, block_size=5, on_block_end=lambda c: (logger(c), echo(c)),
        **{**_KW, "max_iter": 20})
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert len(rows) == 4 and rows[-1]["iteration"] == 20
    assert not rows[-1]["converged"]
    assert lines.getvalue().splitlines()[-1].startswith("[19]: ")
    assert MetricsLogger().summary() == {"iterations": 0, "final_objective": None,
                                         "mean_iters_per_sec": None}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        with named_scope("tpunmf_torch_test_scope"):
            mur(t(lowrank()), 4, **{**_KW, "max_iter": 5})
    path = tmp_path / "prof" / "trace.json"
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "tpunmf_torch_test_scope" in names


def test_determinism_check_passes_and_catches_a_perturbation():
    def run(perturb=0.0):
        r = hals(t(lowrank() + perturb), 5, **{**_KW, "max_iter": 10})
        return (torch.from_numpy(r.w), {"h": r.h, "i": r.i})

    assert determinism_check(run, runs=3)
    calls = iter([0.0, 1e-12])
    with pytest.raises(AssertionError, match="run 1 leaf 0 differs"):
        determinism_check(lambda: run(next(calls)), runs=2)


def test_debug_nans_raises_inside_its_context_only():
    zero = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(FloatingPointError, match="div"):
        with debug_nans():
            zero / zero
    assert bool(torch.isnan(zero / zero).all())  # off outside the context
    with debug_nans(False):
        zero / zero
    x = t(lowrank())
    with debug_nans():  # finite ops pass through
        got = (x.T @ x).sum()
    assert torch.isfinite(got)


def test_enable_compilation_cache_points_the_build(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_BUILD_DIR", _build._BUILD_DIR)
    enable_compilation_cache(str(tmp_path / "kernels"))
    assert _build._BUILD_DIR == (tmp_path / "kernels").resolve()
    assert (tmp_path / "kernels").is_dir()
    if _build.library.cache_info().currsize == 0:
        # once the library is loaded, another directory is refused
        monkeypatch.setattr(_build.library, "cache_info",
                            lambda: type("Info", (), {"currsize": 1})())
    with pytest.raises(RuntimeError, match="already loaded"):
        enable_compilation_cache(str(tmp_path / "other"))
    enable_compilation_cache(str(tmp_path / "kernels"))  # the same one is fine


def test_flatten_stack_and_load_matrix_are_tpunmf_s(tmp_path, rng):
    from scipy import io as sio

    a = rng.random((10, 6)).astype(np.float32)
    np.save(tmp_path / "m.npy", a)
    np.savez(tmp_path / "m.npz", data=a)
    np.savetxt(tmp_path / "m.csv", a, delimiter=",")
    np.savetxt(tmp_path / "m.txt", a)
    sio.savemat(tmp_path / "m.mat", {"data": a})
    sio.savemat(tmp_path / "stack.mat", {"msot": rng.random((4, 3, 5))})
    np.save(tmp_path / "d.npy", a.astype(np.float64))
    for name in ["m.npy", "m.npz", "m.csv", "m.txt", "m.mat", "d.npy"]:
        got = tdata.load_matrix(str(tmp_path / name))
        want = jloaders.load_matrix(str(tmp_path / name))
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = tdata.load_matrix(str(tmp_path / "stack.mat"), key="msot")
    assert got.shape == (12, 5)
    np.testing.assert_array_equal(
        got, jloaders.load_matrix(str(tmp_path / "stack.mat"), key="msot"))
    stack = rng.random((4, 3, 5))
    np.testing.assert_array_equal(tdata.flatten_stack(stack), stack.reshape(12, 5, order="F"))
    with pytest.raises(ValueError, match="unsupported data format"):
        tdata.load_matrix(str(tmp_path / "m.xlsx"))
    with pytest.raises(ValueError, match="expected 2-D or 3-D"):
        tdata.flatten_stack(np.ones((2, 2, 2, 2)))


def test_load_movielens_is_tpunmf_s(tmp_path):
    triples = [(1, 10, 5.0), (1, 20, 3.0), (2, 10, 4.0), (7, 30, 1.0)]
    files = {
        "ratings.dat": "".join(f"{u}::{i}::{r}::978300760\n" for u, i, r in triples),
        "u.data": "".join(f"{u}\t{i}\t{r}\t978300760\n" for u, i, r in triples),
        "ratings.csv": "userId,movieId,rating,timestamp\n" + "".join(
            f"{u},{i},{r},978300760\n" for u, i, r in triples),
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
        mat, users, items = tdata.load_movielens(str(tmp_path / name))
        jmat, jusers, jitems = jloaders.load_movielens(str(tmp_path / name))
        assert mat.shape == (3, 3) and list(users) == [1, 2, 7]
        np.testing.assert_array_equal(mat.toarray(), jmat.toarray())
        np.testing.assert_array_equal(items, jitems)


def test_load_newsgroups_tfidf_is_tpunmf_s(tmp_path):
    (tmp_path / "alt.atheism").mkdir()
    (tmp_path / "sci.space").mkdir()
    (tmp_path / "alt.atheism" / "0001").write_text(
        "The rocket engine burns fuel. Rocket science!")
    (tmp_path / "alt.atheism" / "0002").write_text(
        "Fuel and engine and rocket again, rocket rocket.")
    (tmp_path / "sci.space" / "0001").write_text(
        "Space rocket orbits the moon. Moon base fuel depot.")
    mat, vocab, docs = tdata.load_newsgroups_tfidf(str(tmp_path), min_df=2)
    jmat, jvocab, jdocs = jloaders.load_newsgroups_tfidf(str(tmp_path), min_df=2)
    assert vocab == jvocab and docs == jdocs and "moon" not in vocab
    np.testing.assert_array_equal(mat.toarray(), jmat.toarray())
    # and it factorizes through the port on the CPU
    res = mur(torch.from_numpy(mat.toarray()), 2, distance_type="kl", min_iter=3,
              max_iter=10, tol1=0.0, tol2=0.0)
    assert np.all(np.isfinite(res.obj_history))
    with pytest.raises(ValueError, match="no documents"):
        tdata.load_newsgroups_tfidf(str(tmp_path / "sci.space"))
