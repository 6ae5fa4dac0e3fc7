"""The plain references against tpunmf_torch's plain route, at small
sizes on the CPU in float64, and the generators' and TF32 rounding's
properties.  The references import nothing of the program; here the
program is the witness that they compute the same method."""
import contextlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from nmfbench.harness import fits
from nmfbench.reference import _prec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# iterations compared: ADMM KL amplifies rounding over many iterations
# (PERF.md), so it is compared over fewer
ITERATIONS = {"mur_kl": 30, "admm_kl": 15}


def program_f64(cell, data, w0, h0, iterations):
    import tpunmf_torch

    kw = dict(cell.traffic["factorize"], min_iter=iterations, max_iter=iterations,
              w_init=w0.double(), h_init=h0.double())
    if cell.traffic.get("mask"):
        kw["mask"] = data["mask"]
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return tpunmf_torch.NMF(data["x"].double(), cell.rank).factorize(**kw)


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_program_in_float64(small_cell, name):
    cell = small_cell(name)
    data = fits.make_data(cell, 2**31 + 17, "cpu")
    w0, h0 = fits.make_init(cell, data, 2**31 + 17, 0)
    iterations = ITERATIONS[cell.method]
    got = program_f64(cell, data, w0, h0, iterations)
    mask = data.get("mask") if cell.traffic.get("mask") else None
    w, h, trace = cell.reference().run(data["x"], w0, h0, iterations=iterations,
                                       params=cell.traffic["factorize"], mask=mask)
    np.testing.assert_allclose(np.asarray(got.obj_history), trace, rtol=1e-9)
    np.testing.assert_allclose(got.w, w.numpy(), rtol=1e-7, atol=1e-9 * float(w.abs().max()))
    np.testing.assert_allclose(got.h, h.numpy(), rtol=1e-7, atol=1e-9 * float(h.abs().max()))
    assert cell.reference().objective(data["x"], w, h, mask=mask) == pytest.approx(trace[-1],
                                                                                   rel=1e-12)


def test_round_tf32():
    one_ulp = 2.0 ** -10
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -12),
                      1.0 + one_ulp, 3.0e-3], dtype=torch.float32)
    got = _prec.round_tf32(a)
    assert got[0] == 1.0
    assert got[1] == 1.0                       # a tie goes to the even mantissa
    assert got[2] == 1.0 + 2 * one_ulp         # a tie goes to the even mantissa
    assert got[3] == -1.0
    assert got[4] == 1.0 + one_ulp             # already a TF32 number
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    bits = got.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0


def test_generators_follow_the_seed(small_cell):
    cell = small_cell("tfidf-20news.mur-kl")
    one = fits.make_data(cell, 2**31 + 3, "cpu")
    again = fits.make_data(cell, 2**31 + 3, "cpu")
    other = fits.make_data(cell, 2**31 + 4, "cpu")
    m, n = cell.config["shape"]["m"], cell.config["shape"]["n"]
    assert one["x"].shape == (m, n) and one["x"].dtype == torch.float32
    assert torch.equal(one["x"], again["x"]) and not torch.equal(one["x"], other["x"])
    assert float(one["x"].min()) >= 0.0 and float(one["x"].max()) > 0.0
    per_doc = (one["x"] > 0).sum(dim=0)
    assert int(per_doc.max()) <= cell.config["params"]["doc_len"]
    w0, h0 = fits.make_init(cell, one, 2**31 + 3, 0)
    w1, _ = fits.make_init(cell, one, 2**31 + 3, 1)
    assert torch.equal(w0, fits.make_init(cell, one, 2**31 + 3, 0)[0])
    assert not torch.equal(w0, w1)
    assert float(w0.min()) >= 0.0 and float(w0.max()) < one["init_scale"]
