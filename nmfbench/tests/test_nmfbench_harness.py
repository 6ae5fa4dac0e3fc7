"""The harness: BENCHMARK.json against the contract it is written to,
every name resolved to its files, no JAX loaded, no run without a card,
and the reduction of a profiler trace."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nmfbench.harness import spec, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = spec.NAME.fullmatch
UNIT = spec.UNIT.fullmatch


def one_line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "nmfbench/run.py"]
    assert BENCH["paths"] == ["nmfbench"]
    for word in BENCH["command"]:
        assert one_line(word) and not word.startswith("/") and ".." not in word
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells must fit its 43200 s with this run length
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("nmfbench/") and len(c["reduced"]) <= 16
        assert all(NAME(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME(w["name"]) and NAME(w["config"]) and NAME(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        names.append(w["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME(m["name"]) and UNIT(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(BENCH, name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cell.config["name"] == config["name"] and cell.config["source"] == config["source"]
    assert cell.config["reduced"] == config["reduced"]
    assert callable(cell.generator().make)
    assert callable(cell.work().per_iteration)
    assert callable(cell.reference().run) and callable(cell.reference().objective)
    assert set(cell.limits) >= {"iters"} and cell.limits["iters"] == 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "fit_it_per_s"}
    assert cell.per_layer
    for m in cell.per_layer + cell.end_to_end:
        assert callable(spec.load_module("metrics", m["name"]).read)
    for key in ("iterations", "warmup_iterations", "trace_fits", "check_fits", "factorize"):
        assert key in cell.traffic
    files = [ROOT / config["file"], spec.BENCH_DIR / "traffic" / f"{entry['traffic']}.json",
             spec.BENCH_DIR / "limits" / f"{name}.json"]
    for f in files:
        assert f.is_file() and f.resolve().is_relative_to(spec.BENCH_DIR)


def test_each_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_nothing_imports_jax_or_tpunmf():
    """Import the harness, every file BENCHMARK.json names and the program,
    and drive a small CPU run; no new module is jax, jaxlib, flax or
    tpunmf by its whole top-level name."""
    code = r"""
import json, sys
before = set(sys.modules)
sys.path.insert(0, sys.argv[1])
import nmfbench.run as run
from nmfbench.harness import spec, fits
bench = spec.load_benchmark()
for w in bench["workloads"]:
    cell = spec.resolve(bench, w["name"])
    cell.generator(); cell.work(); cell.reference()
for m in bench["per_layer"]:
    spec.load_module("metrics", m["name"])
import tpunmf_torch
cfg = json.load(open(sys.argv[1] + "/nmfbench/configs/tfidf-20news.json"))
cfg["shape"], cfg["rank"] = {"m": 60, "n": 40}, 4
cell = spec.resolve(bench, "tfidf-20news.mur-kl", config=cfg)
run.run_cell(cell, 3, 0.05, False, device="cpu")
new = {n.split(".")[0] for n in set(sys.modules) - before}
print(json.dumps(sorted(new & {"jax", "jaxlib", "flax", "tpunmf"})))
"""
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from nmfbench import run

    for name in ("jax", "jaxlib", "flax", "tpunmf", "tpunmf.api"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "tpunmf_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxish", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpunmf.api", object())
    assert run.forbidden_modules() == ["tpunmf"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "nmfbench/run.py", "--workload", CELLS[0],
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_unknown_cell_no_result():
    out = subprocess.run([sys.executable, "nmfbench/run.py", "--workload", "no-such.cell",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _x("user_annotation", trace.WINDOW, 100.0, 100.0),
        _x("user_annotation", "nmfbench.fit", 100.0, 100.0),
        _x("kernel", "void ns::k1<8>(float*)", 90.0, 20.0),      # clipped to 100-110
        _x("kernel", "k2", 105.0, 20.0),                         # overlaps k1: union
        _x("gpu_memcpy", "Memcpy DtoH", 150.0, 10.0),
        _x("kernel", "k2", 195.0, 30.0),                         # clipped to 195-200
        _x("cuda_runtime", "cudaStreamSynchronize", 160.0, 5.0),
        _x("cuda_runtime", "cudaMemcpyAsync", 148.0, 2.0),
        _x("cuda_runtime", "cudaLaunchKernel", 130.0, 1.0),
        _x("cpu_op", "aten::mul", 126.0, 30.0),
        _x("cuda_runtime", "cudaDeviceSynchronize", 250.0, 5.0),   # outside the window
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((25 + 10 + 5) * 1e-6)     # union, not sum
    assert r["kernels"] == 2 and r["syncs"] == 1
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["k2"] == pytest.approx(50e-6) and ops["k1"] == pytest.approx(20e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # 125-150 (middle 137.5: aten::mul), 160-195 (middle 177.5: only the fit's span)
    assert gaps["aten::mul"] == pytest.approx(25e-6)
    assert gaps["nmfbench.fit"] == pytest.approx(35e-6)
    assert trace.short_name("void ns::k1<8>(float*)") == "k1"
    assert np.allclose(trace.union(np.array([[3.0, 4.0], [1.0, 2.0], [1.5, 3.5]])),
                       [[1.0, 4.0]])
