"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (``run_cell`` on the CPU at a
small size) and the rest of a run is driven, with
``tpunmf_torch.NMF.factorize`` broken in each way a fit can be: its state
returned unchanged, half of X's columns left out, or an answer altered
where it is produced (one row of W doubled).  Updates stopped after half
the iterations show only at the cells' own size (test_nmfbench_control).  A one-card cell has no
exchange between cards to leave out."""
import json
from pathlib import Path

import numpy as np
import pytest

from nmfbench import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
FAULTS = ("unchanged", "half", "altered")


def broken(real, fault):
    def factorize(self, method="mur", saving=False, **kw):
        if fault == "half":
            x = self.data.clone()
            x[:, x.shape[1] // 2:] = 0
            self.data = x
        r = real(self, method, saving, **kw)
        if fault == "unchanged":
            return r._replace(w=kw["w_init"].cpu().numpy(), h=kw["h_init"].cpu().numpy(),
                              obj_history=[r.obj_history[0]] * len(r.obj_history))
        if fault == "altered":
            w = np.array(r.w, copy=True)
            w[0] *= 2.0
            return r._replace(w=w)
        return r
    return factorize


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    result = run.run_cell(small_cell(name), 2**31 + 101, 0.05, False, device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert list(result["checks"])[-1] == list(small_cell(name).limits)[-1]


def test_traced_run_line(small_cell):
    """A --trace 1 run's line: per-layer metrics only, the trace's window,
    the breakdown, and the checks last (on the CPU no device interval is
    traced, so the device shares are left out)."""
    cell = small_cell("tfidf-20news.admm-kl")
    result = run.run_cell(cell, 2**31 + 5, 0.05, True, device="cpu")
    assert result["correct"] is True
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"launches_per_iter", "syncs_per_iter", "step_mfu"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_fit_is_not_correct(small_cell, monkeypatch, name, fault):
    import tpunmf_torch

    monkeypatch.setattr(tpunmf_torch.NMF, "factorize", broken(tpunmf_torch.NMF.factorize, fault))
    result = run.run_cell(small_cell(name), 2**31 + 101, 0.05, False, device="cpu")
    assert result["correct"] is False and result["failed"] >= 1
