"""BASELINE's config harness and the HALS time-to-objective bench in the port.

``tpunmf_torch.sweeps.run_configs``' five config functions run at small
scales in float64 on the CPU and are held to ``benchmarks/run_configs.py``'s
own functions, loaded by file path (its import-time ``XLA_FLAGS`` and
``jax.config`` updates under ``mock.patch``; conftest has already made the
same settings, so they change nothing here): the stop iteration exactly,
errors, KL divergences and the mesh run's KL within TRACE_RTOL.  The
script's reference package is absent, so it reports its own runs only; the
port's yardstick keys are held to its own float64 route.  Config 4's mesh
run is the port's one-rank CPU mesh against the script's (2, 4) mesh on 8
JAX CPU devices.  ``tpunmf_torch.sweeps.bench_hals``' three runs are held
to ``tpunmf``'s ``mur`` / ``hals`` from the same inits (bench_hals.py runs
its 8192^2 problem when imported, so its keywords are repeated here).
"""
import functools
import importlib.util
import json
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from _torch_parity import TRACE_RTOL
from tpunmf_torch.sweeps import bench_hals, run_configs

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmarks", "run_configs.py")
# the smallest scales the scale rule leaves room for: config0 64x48 r20,
# config1 200x110 r50, config2 120x80 r40, config3 200x100 r50, config4
# 128x64 r32
SCALES = (0.02, 0.01, 0.02, 0.004, 0.01)
# --max-iter-cap for config2 on both sides (ANLS's FCNNLS is the slowest here)
CAPS = (None, None, 10, None, None)
# the f32 CPU route against float64 (plain_f32's deviation): 2.1e-5 observed
F32_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def script():
    """benchmarks/run_configs.py, its environment and JAX settings left as
    they were."""
    spec = importlib.util.spec_from_file_location("_benchmarks_run_configs", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ), mock.patch.object(jax.config, "update"):
        spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def ours(idx):
    """The port's config ``idx`` at SCALES[idx], 'ours' in float64 on the CPU."""
    kw = {} if CAPS[idx] is None else {"cap": CAPS[idx]}
    return run_configs.runners()[idx](SCALES[idx], device="cpu", dtype=torch.float64, **kw)


def _script_config(idx):
    mod = script()
    with mock.patch.object(mod, "MAX_ITER_CAP", CAPS[idx]):
        return [mod.config0_mur_eu, mod.config1_mur_kl, mod.config2_anls_recall,
                mod.config3_admm_sparse, mod.config4_ao_admm_sharded][idx](SCALES[idx])


# the values both reports hold, by config
SHARED = {0: ("rel_err",), 1: ("final_kl",), 2: ("rel_err",), 3: (), 4: ("final_kl",)}


@pytest.mark.parametrize("idx", range(5))
def test_configs_match_the_script_at_float64(idx):
    want, got = _script_config(idx), ours(idx)
    assert got["config"] == want["config"] and got["shape"] == want["shape"]
    if idx == 3:
        for run in ("fixed", "rho_damped"):
            assert got[run]["i"] == want[run]["i"]
            np.testing.assert_allclose(got[run]["rel_err"], want[run]["rel_err"],
                                       rtol=TRACE_RTOL)
    else:
        assert got["i"] == want["i"]
    for key in SHARED[idx]:
        np.testing.assert_allclose(got[key], want[key], rtol=TRACE_RTOL)
    if idx == 4:
        assert want["sharded_matches"] and got["sharded_matches"]
        np.testing.assert_allclose(got["sharded_final_kl"], want["sharded_final_kl"],
                                   rtol=TRACE_RTOL)
        assert got["mesh"] == [1, 1] and got["sharded_same_bits"]


@pytest.mark.parametrize("idx", range(5))
def test_yardstick_keys_against_float64(idx):
    """At float64 ours is the yardstick's route (deviation 0, the same stop);
    the plain f32 route stays within F32_RTOL of it."""
    got = ours(idx)
    keys = {"ref_i", "final_err_deviation", "iters_match", "plain_f32", "init_s",
            "ref_wall_s"}
    keys |= {0: {"ref_rel_err"}, 1: {"ref_final_kl"}, 2: {"ref_rel_err", "recall10_vs_ref"},
             3: {"ref_rel_err", "trajectory_max_rel_dev", "ref_self_divergence"},
             4: {"ref_final_kl", "sharded_final_kl", "sharded_matches"}}[idx]
    assert keys <= set(got), keys - set(got)
    assert got["final_err_deviation"] == 0.0 and got["iters_match"]
    plain = got["plain_f32"]
    assert {"i", "final_err_deviation"} <= set(plain)
    assert 0.0 < plain["final_err_deviation"] < F32_RTOL
    assert run_configs.gate(got) == (True, run_configs.GATE)
    if idx == 2:
        assert got["recall10_vs_ref"] == 1.0
    if idx == 3:
        assert got["trajectory_max_rel_dev"] == 0.0
        assert 0.0 < plain["trajectory_max_rel_dev"] < F32_RTOL
        assert got["ref_self_divergence"] < 1e-10


def test_gate_takes_twice_the_plain_route_where_that_is_past_the_target():
    rec = {"final_err_deviation": 3e-4, "plain_f32": {"final_err_deviation": 2e-4}}
    assert run_configs.gate(rec) == (True, 4e-4)
    rec["final_err_deviation"] = 5e-4
    assert run_configs.gate(rec) == (False, 4e-4)
    rec = {"final_err_deviation": 2e-4, "plain_f32": {"final_err_deviation": 1e-5}}
    assert run_configs.gate(rec) == (False, run_configs.GATE)


# the keywords each solver's nndsvd_init run and w_init run share
INIT_RUNS = {"mur": dict(distance_type="kl", min_iter=5, max_iter=5),
             "anls": dict(use_fcnnls=True, min_iter=3, max_iter=3),
             "admm": dict(reg_h=(0.1, "l1n"), min_iter=5, max_iter=5),
             "ao_admm": dict(distance_type="kl", reg_w=(0.05, "l1n"), reg_h=(0.05, "l2n"),
                             min_iter=5, max_iter=5)}


@pytest.mark.parametrize("method", sorted(INIT_RUNS))
def test_the_f64_init_gives_the_nndsvd_init_bits(method):
    from tpunmf_torch import solvers

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((60, 8)) @ rng.random((8, 40)) + 0.01)
    fit = getattr(solvers, method)
    init, _ = run_configs.init_f64(x, 6)
    a = fit(x, 6, nndsvd_init=(True, "zero"), **INIT_RUNS[method])
    b = fit(x, 6, w_init=init[0], h_init=init[1], **INIT_RUNS[method])
    assert a.i == b.i
    for f in ("w", "h", "obj_history"):
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f


def test_errors_on_the_device_match_numpy():
    rng = np.random.default_rng(6)
    x, w, h = rng.random((9000, 30)) + 0.1, rng.random((9000, 4)), rng.random((4, 30))
    tx, tw, th = (torch.from_numpy(a) for a in (x, w, h))
    want = np.linalg.norm(x - w @ h) / np.linalg.norm(x)
    np.testing.assert_allclose(run_configs.rel_err(tx, tw, th), want, rtol=1e-12)
    # X in float32 is cast up exactly, block by block
    x32 = x.astype(np.float32).astype(np.float64)
    want32 = np.linalg.norm(x32 - w @ h) / np.linalg.norm(x32)
    np.testing.assert_allclose(run_configs.rel_err(tx.float(), tw, th), want32, rtol=1e-12)
    wh = w @ h
    kl = np.sum(x * np.log(x / wh) - x + wh)
    np.testing.assert_allclose(run_configs.kl_f64(tx, tw, th), kl, rtol=1e-10)


def test_a_given_matrix_must_have_the_scale_rules_shape():
    for fn in (run_configs.config1_mur_kl, run_configs.config3_admm_sparse):
        with pytest.raises(ValueError, match="x is"):
            fn(0.02, device="cpu", x=torch.zeros(10, 10))


def test_main_flags_and_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = run_configs.main(["--scale", "0.004", "--configs", "0,3", "--device", "cpu",
                           "--max-iter-cap", "30", "--out", str(out)])
    assert rc == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    report = json.loads(out.read_text())
    assert set(report) == {"scale", "reference", "reference_available", "max_iter_cap",
                           "device", "configs"}
    assert report["reference"] == "float64 plain route on cpu"
    assert report["reference_available"] and report["max_iter_cap"] == 30
    assert [c["config"] for c in report["configs"]] == ["MUR-EU dense", "ADMM sparse L1(H)"]
    assert lines == report["configs"]
    c0 = report["configs"][0]
    assert c0["i"] <= 29 and c0["ref_i"] <= 29 and "total_wall_s" in c0
    assert run_configs.gate(c0)[0] and run_configs.gate(report["configs"][1])[0]


def test_both_scripts_refuse_to_start_without_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_configs.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert bench_hals.main(["all", str(tmp_path / "b.jsonl")]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert not (tmp_path / "b.jsonl").exists()


HALS_SHAPE, HALS_ITERS = (64, 48, 6), 20


@pytest.mark.parametrize("name", sorted(bench_hals.CONFIGS))
def test_bench_hals_runs_match_tpunmf(name):
    from tpunmf.solvers import hals, mur

    x, w0, h0 = bench_hals.problem(*HALS_SHAPE, device="cpu", dtype=torch.float64)
    res, seconds = bench_hals.run(name, x, w0, h0, HALS_ITERS)
    fn, kw = {"mur_eu": (mur, dict(distance_type="eu")),
              "hals_s1": (hals, dict(inner_sweeps=1)),
              "hals_s2": (hals, dict(inner_sweeps=2))}[name]
    want = fn(x.numpy(), HALS_SHAPE[2], w_init=w0.numpy(), h_init=h0.numpy(),
              min_iter=HALS_ITERS, max_iter=HALS_ITERS, tol1=0.0, tol2=0.0, **kw)
    np.testing.assert_allclose(res.obj_history, np.asarray(want.obj_history), rtol=TRACE_RTOL)
    assert len(res.obj_history) == HALS_ITERS + 1
    rec = bench_hals.record(name, res, seconds, x, HALS_ITERS)
    assert set(rec) == {"name", "s_total", "it_per_s", "shape", "obj"}
    assert rec["shape"] == list(HALS_SHAPE) and rec["obj"] == [float(v) for v in
                                                              res.obj_history]
    assert bench_hals.time_to(rec, rec["obj"][-1])[0] <= HALS_ITERS
    assert bench_hals.time_to(rec, 0.0) is None


def test_bench_hals_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "b.jsonl"
    assert bench_hals.main(["all", str(out), "--device", "cpu", "--shape", "40,30,4"]) == 0
    recs = [json.loads(s) for s in out.read_text().splitlines()]
    assert [r["name"] for r in recs] == list(bench_hals.CONFIGS)
    assert all(len(r["obj"]) == bench_hals.ITERS + 1 and r["shape"] == [40, 30, 4]
               for r in recs)
    # HALS reaches a lower objective than MUR in the same iterations
    assert recs[1]["obj"][-1] < recs[0]["obj"][-1]


@pytest.mark.parametrize("method", ["anls", "admm", "ao_admm"])
def test_one_device_solvers_take_row_major_factors(method, monkeypatch):
    """A column-major init (NNDSVD's U, or a Fortran-ordered w_init) enters
    the loop row-major, as the mesh solvers place their blocks: cuBLAS rounds
    by layout, so a world of one gave other bits than one device (config 4
    on the card, 6e-5 apart after 60 iterations)."""
    import importlib

    mod = importlib.import_module(f"tpunmf_torch.solvers.{method}")
    seen = []
    real = mod.init_carry

    def spy(obj0, max_iter, inner):
        seen.append([f.is_contiguous() for f in inner[:2]])
        return real(obj0, max_iter, inner)

    monkeypatch.setattr(mod, "init_carry", spy)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random((50, 6)) @ rng.random((6, 30)) + 0.01)
    w0, h0 = run_configs.init_f64(x, 4)[0]
    assert not w0.is_contiguous()
    fit = getattr(importlib.import_module("tpunmf_torch.solvers"), method)
    fit(x, 4, min_iter=2, max_iter=2)
    fit(x, 4, w_init=w0, h_init=h0, min_iter=2, max_iter=2)
    assert seen == [[True, True], [True, True]]
