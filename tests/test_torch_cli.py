"""``python -m tpunmf_torch``: the CLI's commands in-process with
``--device cpu`` (factorize, its ``--checkpoint`` resume, ``--beta``, grid,
the refusals), held against tpunmf's CLI on the same file, and one run in
a subprocess."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpunmf.__main__ import main as jmain
from tpunmf_torch.__main__ import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def data_file(tmp_path, rng):
    path = tmp_path / "data.npy"
    np.save(path, rng.random((60, 40)) ** 2)
    return str(path)


def _rows(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _factorize(data, tmp_path, *extra):
    return ["factorize", data, "-k", "4", "-m", "mur", "--min-iter", "3",
            "--max-iter", "20", "--tol1", "1e-6", "--tol2", "1e-6", "--nndsvd",
            "zero", "--save-dir", str(tmp_path / "out"), *extra]


def test_factorize_matches_tpunmf_s_cli(tmp_path, data_file, capsys):
    args = _factorize(data_file, tmp_path, "--distance-type", "eu")
    assert jmain(args) == 0
    want = _rows(capsys.readouterr().out)[0]
    want_files = sorted(os.listdir(tmp_path / "out"))
    for name in want_files:
        os.unlink(tmp_path / "out" / name)
    assert tmain(args + ["--device", "cpu"]) == 0
    got = _rows(capsys.readouterr().out)[0]
    assert got["iterations"] == want["iterations"] == 19
    np.testing.assert_allclose(got["final_objective"], want["final_objective"],
                               rtol=1e-10)
    assert sorted(os.listdir(tmp_path / "out")) == want_files
    assert want_files[0].startswith("nmf_mur_4_eu")


def test_factorize_checkpoint_resumes(tmp_path, data_file, capsys):
    ck = str(tmp_path / "state")
    args = _factorize(data_file, tmp_path, "--distance-type", "kl", "--device", "cpu",
                      "--checkpoint", ck, "--no-save")
    assert tmain(args) == 0
    first = _rows(capsys.readouterr().out)[0]
    assert os.path.exists(ck + ".npz")
    with np.load(ck + ".npz", allow_pickle=True) as f:
        assert int(f["leaf_0"]) == first["iterations"] + 1
    # the second run resumes at the saved end: the same iterations and objective
    assert tmain(args) == 0
    assert _rows(capsys.readouterr().out)[0] == first


def test_factorize_beta(tmp_path, data_file, capsys):
    args = _factorize(data_file, tmp_path, "--beta", "0.5")
    assert jmain(args + ["--no-save"]) == 0
    want = _rows(capsys.readouterr().out)[0]
    assert tmain(args + ["--device", "cpu"]) == 0
    got = _rows(capsys.readouterr().out)[0]
    assert got["iterations"] == want["iterations"]
    np.testing.assert_allclose(got["final_objective"], want["final_objective"],
                               rtol=1e-10)
    assert os.listdir(tmp_path / "out")[0].startswith("nmf_mur_4_beta0.5")


def test_grid_command(tmp_path, data_file, capsys):
    args = ["grid", data_file, "-k", "4", "-m", "mur", "--features", "3,4",
            "--lambda-w", "0,0.1", "--distance-type", "eu", "--min-iter", "2",
            "--max-iter", "8", "--nndsvd", "zero", "--no-save"]
    assert jmain(args) == 0
    want = _rows(capsys.readouterr().out)
    assert tmain(args + ["--device", "cpu"]) == 0
    got = _rows(capsys.readouterr().out)
    assert len(got) == 4 and {row["k"] for row in got} == {3, 4}
    for g, w in zip(got, want):
        assert g["i"] == w["i"] and (g["k"], g["lambda_w"]) == (w["k"], w["lambda_w"])
        np.testing.assert_allclose(g["final_objective"], w["final_objective"],
                                   rtol=1e-10)


@pytest.mark.parametrize("argv,code,message", [
    (["grid", "-k", "3", "--checkpoint", "ck"], 2, "not supported with grid"),
    (["grid", "-k", "3", "-m", "ntf"], 2, "grid does not support"),
    (["grid", "-k", "3", "-m", "robust"], 2, "grid does not support"),
    # the id predates the port of ntf: factorize -m ntf now runs, and prints
    # tpunmf's line (both CLIs read one factors_init from a parameter module)
    (["factorize", "-k", "3", "-m", "ntf", "--ntf-update", "hals"], 0, None),
    (["grid", "-k", "3", "-m", "ntf", "--ntf-update", "hals"], 2,
     "grid does not support -m ntf"),
], ids=["grid_checkpoint", "grid_ntf", "grid_robust", "unported", "grid_unported"])
def test_refusals(tmp_path, data_file, capsys, monkeypatch, argv, code, message):
    args = [argv[0], data_file, *argv[1:], "--no-save", "--max-iter", "2"]
    if code == 0:
        (tmp_path / "ntf_cli_params.py").write_text(
            "import numpy as np\n"
            "_rng = np.random.default_rng(0)\n"
            "method_params = {'factors_init': [_rng.random((60, 3)) + 0.1,\n"
            "                                  _rng.random((40, 3)) + 0.1]}\n")
        monkeypatch.syspath_prepend(str(tmp_path))
        args += ["--param-file", "ntf_cli_params", "--tol1", "0", "--tol2", "0"]
        assert jmain(args) == 0
        want = _rows(capsys.readouterr().out)
    assert tmain(args + ["--device", "cpu"]) == code
    if code == 0:
        got = _rows(capsys.readouterr().out)
        assert len(got) == len(want) == 1 and got[0]["method"] == "ntf"
        assert got[0]["iterations"] == want[0]["iterations"] == 1
        np.testing.assert_allclose(got[0]["final_objective"], want[0]["final_objective"],
                                   rtol=1e-10)
        return
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("method,extra", [
    ("onmf", ["--nndsvd", "zero"]),
    ("robust", []),  # NNDSVD 'zero' by default
])
def test_factorize_new_methods_match_tpunmf_s_cli(tmp_path, data_file, capsys, method,
                                                  extra):
    args = ["factorize", data_file, "-k", "4", "-m", method, "--min-iter", "5",
            "--max-iter", "12", "--tol1", "0", "--tol2", "0", "--no-save", *extra]
    assert jmain(args) == 0
    want = _rows(capsys.readouterr().out)[0]
    assert tmain(args + ["--device", "cpu"]) == 0
    got = _rows(capsys.readouterr().out)[0]
    # ONMF's objective may rise, which stops a run early: the same iteration
    assert got["method"] == method and got["iterations"] == want["iterations"] > 5
    np.testing.assert_allclose(got["final_objective"], want["final_objective"],
                               rtol=1e-10)


def test_factorize_semi_nmf_runs(tmp_path, data_file, capsys):
    # its random init is torch's own draw, so only the run is held
    args = ["factorize", data_file, "-k", "4", "-m", "semi_nmf", "--min-iter", "5",
            "--max-iter", "12", "--tol1", "0", "--tol2", "0", "--no-save", "--device", "cpu"]
    assert tmain(args) == 0
    got = _rows(capsys.readouterr().out)[0]
    assert got["iterations"] == 11 and np.isfinite(got["final_objective"])


@pytest.mark.parametrize("extra,message", [
    (["-m", "hals", "--beta", "1"], "--beta requires -m mur"),
    (["--beta", "1", "--distance-type", "kl"], "mutually exclusive"),
    (["-m", "onmf", "--distance-type", "eu"], "does not apply to onmf"),
    (["-m", "ntf", "--nndsvd", "zero"], "does not apply to ntf"),
])
def test_flag_checks_are_tpunmf_s(tmp_path, data_file, extra, message):
    args = ["factorize", data_file, "-k", "3", "--no-save", *extra]
    with pytest.raises(SystemExit, match=message):
        jmain(args)
    with pytest.raises(SystemExit, match=message):
        tmain(args + ["--device", "cpu"])


def test_default_device_is_the_card(tmp_path, data_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run goes there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmain(["factorize", data_file, "-k", "3", "--max-iter", "2", "--no-save"])


def test_module_runs_in_a_subprocess(tmp_path, data_file):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "tpunmf_torch", *_factorize(data_file, tmp_path,
                                                           "--distance-type", "eu",
                                                           "--device", "cpu")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _rows(r.stdout)[0]["iterations"] == 19
    assert os.listdir(tmp_path / "out")[0].startswith("nmf_mur_4_eu")
    bad = subprocess.run([sys.executable, "-m", "tpunmf_torch", "explode"],
                         capture_output=True, text=True, env=env, cwd=str(tmp_path),
                         timeout=240)
    assert bad.returncode != 0
