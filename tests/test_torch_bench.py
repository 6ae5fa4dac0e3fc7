"""``tpunmf_torch.bench`` (``python -m tpunmf_torch bench``) against the
repository's ``bench.py`` at small shapes on the CPU: the flop and byte
counts, the keys of every sub-bench and of the printed line, the probe
tracker's rules with its timing stubbed, the raise after a recorded error,
and the CLI's subcommand.  The rates themselves are the card's and are not
compared."""
import ast
import builtins
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

import bench
import tpunmf.utils
import tpunmf_torch.bench as tb
from tpunmf.__main__ import main as jmain
from tpunmf_torch.__main__ import main as tmain
from tpunmf_torch.ops.roofline import PEAK_BF16, PEAK_BYTES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(m=128, n=128, k=8, iters=4)
SMALL_SERVING = dict(b=4, r=8, n=4096, topk=10, iters=2)
SMALL_RATES = dict(m=96, n=64, k=6, iters=3)
SMALL_TRACKER = dict(mb=1, gemm_shape=(128, 64, 8), mxu_dim=64, device="cpu")
H100 = "NVIDIA H100 80GB HBM3"
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def h100(monkeypatch):
    """The bench's card check answers as an H100 would."""
    monkeypatch.setattr(tb, "_card_name", lambda: H100)


@pytest.fixture(scope="module")
def jax_results():
    """bench.py's sub-benches at small shapes on the JAX CPU backend."""
    out = {}
    for name, (_, jdt) in DTYPES.items():
        out["eu", name] = bench.bench_mur_eu(**SMALL, data_dtype=jdt)
        out["kl", name] = bench.bench_mur_kl(**SMALL, data_dtype=jdt)
    out["serving"] = bench.bench_serving(**SMALL_SERVING)
    return out


def _bench_py_rate_families():
    """The families bench.py's bench_solver_rates reports (out["..."] = ...)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_solver_rates")
    return [t.slice.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript)
            and isinstance(t.value, ast.Name) and t.value.id == "out"]


def _bench_py_rate_deltas():
    """bench.py's delta of each family (out["..."] = rate(fn, delta, ...))."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_solver_rates")
    return {n.targets[0].slice.value: n.value.args[1].value for n in ast.walk(fn)
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
            and isinstance(n.value, ast.Call) and getattr(n.value.func, "id", "") == "rate"}


@pytest.fixture(scope="module")
def port_rates():
    """The port's solver rates at a small shape, each family's delta 2."""
    return tb.bench_solver_rates(**SMALL_RATES, device="cpu",
                                 deltas={name: 2 for name in tb.RATE_DELTAS})


def _port(dist, dtype, **kw):
    fn = tb.bench_mur_eu if dist == "eu" else tb.bench_mur_kl
    return fn(**SMALL, data_dtype=DTYPES[dtype][0], device="cpu", **kw)


@pytest.mark.parametrize("dist", ["eu", "kl"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_counts_and_keys_are_bench_py_s(h100, jax_results, dist, dtype):
    got = _port(dist, dtype)
    want = jax_results[dist, dtype]
    assert set(got) == set(want)
    assert got["bytes_per_iter"] == want["bytes_per_iter"]
    assert got["flops_per_iter"] == want["flops_per_iter"]
    for bw in (1e11, 2.9e12):
        assert tb._refraction(got, bw) == bench._refraction(got, bw)
    assert got["peak_flops"] == PEAK_BF16
    assert math.isfinite(got["iters_per_sec"]) and got["iters_per_sec"] > 0
    if dist == "eu":
        assert math.isfinite(got["final_obj"]) and got["final_obj"] > 0
        assert got["hbm_nominal"] == PEAK_BYTES and got["device"] == "cpu"
        assert got["single_pass"] is False  # the CPU takes the plain route: two passes


def test_kl_every_eighth_objective_runs(h100, jax_results):
    got = _port("kl", "bf16", objective_every=8)
    assert set(got) == set(jax_results["kl", "bf16"])
    assert math.isfinite(got["iters_per_sec"]) and got["iters_per_sec"] > 0


def test_serving_keys_and_recall(jax_results):
    got = tb.bench_serving(**SMALL_SERVING, device="cpu")
    assert set(got) == set(jax_results["serving"])
    assert 0.0 <= got["recall_at_100_quantized_vs_exact"] <= 1.0
    assert got["qps_exact_f32"] > 0 and got["qps_quantized_bf16"] > 0


def test_solver_rates_cover_bench_py_s_families(port_rates):
    families = _bench_py_rate_families()
    assert len(families) == 8
    assert list(port_rates) == families == list(tb.RATE_DELTAS)
    assert all(rate > 0 for rate in port_rates.values())


def test_rate_deltas_are_bench_py_s_and_the_cli_replaces_named_ones(monkeypatch):
    """RATE_DELTAS is bench.py's; ``bench`` runs with them unless
    ``--deltas`` names families, whose counts it replaces."""
    from tpunmf_torch.__main__ import _deltas

    assert tb.RATE_DELTAS == _bench_py_rate_deltas()
    seen = []
    monkeypatch.setattr(tb, "main", lambda deltas=None: seen.append(deltas))
    assert tmain(["bench"]) == 0
    assert tmain(["bench", "--deltas", "ao_admm=200,ao_admm_local_l1inf=100"]) == 0
    assert seen == [tb.RATE_DELTAS,
                    {**tb.RATE_DELTAS, "ao_admm": 200, "ao_admm_local_l1inf": 100}]
    assert tb.RATE_DELTAS == _bench_py_rate_deltas()  # the table itself is untouched
    with pytest.raises(SystemExit, match="no solver family 'admm_x'"):
        _deltas("admm_x=3")
    for bad in ("ao_admm", "ao_admm=", "ao_admm=0", "ao_admm=-5", "ao_admm=2.5", "ao_admm=x"):
        with pytest.raises(SystemExit, match="count of at least 1"):
            _deltas(bad)


def _tree(obj):
    return {k: _tree(v) for k, v in obj.items()} if isinstance(obj, dict) else None


def _small_port(monkeypatch, port_rates, serving=None):
    """Swap the port's sub-benches and tracker for their small CPU calls."""
    real_eu, real_kl, real_serving = tb.bench_mur_eu, tb.bench_mur_kl, tb.bench_serving
    real_tracker = tb.BandwidthTracker
    monkeypatch.setattr(tb, "BandwidthTracker", lambda: real_tracker(**SMALL_TRACKER))
    monkeypatch.setattr(tb, "bench_mur_eu", lambda **kw: real_eu(
        **SMALL, data_dtype=kw.get("data_dtype", torch.float32), device="cpu"))
    monkeypatch.setattr(tb, "bench_mur_kl", lambda **kw: real_kl(**SMALL, device="cpu", **kw))
    monkeypatch.setattr(tb, "bench_serving", serving or (
        lambda **kw: real_serving(**SMALL_SERVING, device="cpu")))
    monkeypatch.setattr(tb, "bench_solver_rates", lambda **kw: dict(port_rates))


def _last_json(out):
    return json.loads([row for row in out.splitlines() if row.startswith("{")][-1])


def test_main_prints_bench_py_s_line(h100, monkeypatch, tmp_path, capsys, jax_results,
                                     port_rates):
    record = os.path.join(REPO, "benchmarks", "bw_probe_best.json")
    before = open(record, "rb").read()
    # bench.py's main on the JAX side: its probe record in tmp_path, its
    # probes' timing stubbed (their full-size chain is minutes on a CPU),
    # its sub-benches the small results above
    class QuietTracker(bench.BandwidthTracker):
        def __init__(self):
            super().__init__(mb=1, gemm_shape=(64, 64, 8))

        def _delta_time(self, fn, i1, i2):
            return 1.0

    def jdtype(kw, default):
        return "bf16" if kw.get("data_dtype", default) == jnp.bfloat16 else "f32"

    monkeypatch.setattr(bench, "_PROBE_STORE", str(tmp_path / "bw_probe_best.json"))
    monkeypatch.setattr(tpunmf.utils, "enable_compilation_cache", lambda *a: None)
    monkeypatch.setattr(bench, "BandwidthTracker", QuietTracker)
    monkeypatch.setattr(bench, "bench_mur_eu",
                        lambda **kw: dict(jax_results["eu", jdtype(kw, jnp.float32)]))
    monkeypatch.setattr(bench, "bench_mur_kl",
                        lambda **kw: dict(jax_results["kl", jdtype(kw, jnp.bfloat16)]))
    monkeypatch.setattr(bench, "bench_serving", lambda **kw: dict(jax_results["serving"]))
    monkeypatch.setattr(bench, "bench_solver_rates",
                        lambda: {name: 1.0 for name in _bench_py_rate_families()})
    bench.main()
    want = _last_json(capsys.readouterr().out)

    assert os.path.exists(tmp_path / "bw_probe_best.json")  # bench.py's record went there
    _small_port(monkeypatch, port_rates)
    line = tb.main()
    got = _last_json(capsys.readouterr().out)
    assert got == json.loads(json.dumps(line))
    assert _tree(got) == _tree(want)
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert got["value"] > 0 and got["vs_baseline"] > 0
    assert got["extra"]["bw_probe_gbps"]["best_prior"] == 0.0
    assert got["extra"]["bw_probe_gbps"]["nominal"] == PEAK_BYTES / 1e9
    assert tb.errors(got) == []
    assert open(record, "rb").read() == before


def test_a_recorded_error_raises_after_printing(h100, monkeypatch, capsys, port_rates):
    def broken(**kw):
        raise RuntimeError("serving broke")

    _small_port(monkeypatch, port_rates, serving=broken)
    with pytest.raises(RuntimeError, match="serving_topk.error, extra.serving_topk_r512.error"):
        tb.main()
    line = _last_json(capsys.readouterr().out)
    assert line["extra"]["serving_topk"] == {"error": "serving broke"}
    assert line["extra"]["serving_topk_r512"] == {"error": "serving broke"}
    assert tb.errors(line) == ["extra.serving_topk.error", "extra.serving_topk_r512.error"]


def test_the_line_names_deltas_that_are_not_bench_py_s(h100, monkeypatch, capsys, port_rates):
    """Rates taken at other deltas than RATE_DELTAS say so in the line;
    at RATE_DELTAS it has bench.py's keys (test_main_prints_bench_py_s_line)."""
    _small_port(monkeypatch, port_rates)
    deltas = {**tb.RATE_DELTAS, "ao_admm": 200, "ao_admm_local_l1inf": 100}
    line = tb.main(deltas=deltas)
    assert _last_json(capsys.readouterr().out) == json.loads(json.dumps(line))
    assert line["extra"]["solver_rate_deltas"] == deltas
    assert "solver_rate_deltas" not in tb.main(deltas=dict(tb.RATE_DELTAS))["extra"]


def test_tracker_rules_with_timing_stubbed(h100, monkeypatch):
    """Samples above the nominal memory rate, or above 1.25 x the nominal
    bf16 peak, are discarded; the memory ceiling is capped at the nominal,
    the product ceiling is at least the nominal; no disk is touched."""
    def no_disk(*args, **kw):
        raise AssertionError(f"the tracker touched the disk: {args}")

    m, n, _ = SMALL_TRACKER["gemm_shape"]
    x_bytes, stream_bytes, mxu_flops = m * n * 4, 2 * 1024 * 1024, 2 * 64 ** 3

    def sample(tr, mp, read, total, stream, gemm, mxu):
        """One sample() whose probes measure these rates: read probe,
        torch.sum, stream, GEMM (bytes/s), chained GEMM (FLOP/s)."""
        times = iter([x_bytes / read, x_bytes / total, stream_bytes / stream,
                      x_bytes / gemm, mxu_flops / mxu])
        mp.setattr(tr, "_delta_time", lambda fn, i1, i2: next(times))
        tr.sample()

    with monkeypatch.context() as mp:
        mp.setattr(builtins, "open", no_disk)
        mp.setattr(os, "makedirs", no_disk)
        tr = tb.BandwidthTracker(**SMALL_TRACKER)
        sample(tr, mp, 4e12, 1e12, 2e12, 0.5e12, 1.3 * PEAK_BF16)
        assert tr.anomalies == [4000.0]
        assert len(tr.anomalies_mxu) == 1
        assert tr.anomalies_mxu[0] == pytest.approx(1.3 * PEAK_BF16)
        assert tr.bw_ceiling == pytest.approx(2e12)
        assert tr.mxu_ceiling == PEAK_BF16  # no sane sample: the nominal
        sample(tr, mp, 3.0e12, 1.5e12, 3.3e12, 0.6e12, 1.1 * PEAK_BF16)
        summary = tr.summary()
    assert tr.anomalies == [4000.0] and len(tr.anomalies_mxu) == 1
    assert tr.samples_read == pytest.approx([1e12, 3.0e12, 1.5e12])
    assert tr.samples_stream == pytest.approx([2e12, 3.3e12])
    assert tr.bw_ceiling == pytest.approx(3.3e12)
    assert tr.mxu_ceiling == pytest.approx(1.1 * PEAK_BF16)  # a sane sample above it
    assert summary["best_prior"] == 0.0
    assert summary["used"] == round(tr.bw_ceiling / 1e9, 1)
    assert summary["discarded_anomalies_gbps"] == [4000.0]
    tr.samples_gemm.append(9e12)  # no sample() keeps this, but were one kept:
    assert tr.bw_ceiling == PEAK_BYTES
    assert set(summary) == {"mxu_samples_tflops", "mxu_discarded_anomalies_tflops",
                            "read_samples", "stream_rw_samples", "gemm_read_samples",
                            "best_this_run", "best_prior", "used",
                            "discarded_anomalies_gbps"}


def test_the_tracker_probes_run_on_the_cpu(h100):
    tr = tb.BandwidthTracker(**SMALL_TRACKER)
    tr.sample(iters=2)
    kept = tr.samples_read + tr.samples_stream + tr.samples_gemm
    assert len(kept) + len(tr.anomalies) == 4  # read probe, torch.sum, stream, GEMM
    assert len(tr.samples_mxu) == 1
    assert float(tr._mxu(3)) == 1.0  # the chain of products stays at one


def test_chip_limits_are_the_h100_s_and_only_its(monkeypatch):
    monkeypatch.setattr(tb, "_card_name", lambda: H100)
    assert tb._chip_limits() == (989e12, 3.35e12)
    monkeypatch.setattr(tb, "_card_name", lambda: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no nominal rates"):
        tb._chip_limits()


def test_without_a_card_main_and_the_cli_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["bench"])
    done = subprocess.run([sys.executable, "-m", "tpunmf_torch", "bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr and not done.stdout.strip()


@pytest.mark.parametrize("cli", [jmain, tmain], ids=["tpunmf", "tpunmf_torch"])
def test_bench_is_a_subcommand_beside_factorize_and_grid(cli, capsys):
    with pytest.raises(SystemExit) as done:
        cli(["--help"])
    assert done.value.code == 0
    assert "{factorize,grid,bench}" in capsys.readouterr().out


def test_no_tpu_constant_or_number_in_the_port():
    src = open(os.path.join(REPO, "tpunmf_torch", "bench.py")).read()
    for word in ("_CHIP", "197e12", "819e9", "v5e", "TPU", "942 -> 1225", "203 vs 393",
                 "197TF", "418 GB/s", "bw_probe_best.json", "_PROBE_STORE"):
        assert word not in src, word
    tree = ast.parse(src)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert "torch" in names
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "tpunmf", "bench")]
