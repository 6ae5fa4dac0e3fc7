"""The control and the faults come out not correct, the program correct.

The control is each cell's plain reference put in the program's place and
computed one precision below what the configuration states (float32 with
TF32 products, for float32 with TF32 off).  On the CPU at a small copy of
each cell; on the card (marked ``cuda``) at the cell's own size, the
readings ``nmfbench/calibrate.py`` sets the limits from.  Updates stopped
after half the iterations are held only there: the small copies converge
sooner, so H moves less after the stall (MUR KL's h_gap 0.7-1.5e-2 at
1000 x 600, 3.0-4.3e-2 at the cell's size; PERF.md)."""
import json
from pathlib import Path

import pytest

from nmfbench import calibrate
from nmfbench.harness import check

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 211, 2**31 + 223, 2**31 + 227)


def _holds(cell, numbers):
    return not check.breaks(cell, numbers)


@pytest.mark.parametrize("name", CELLS)
def test_control_breaks_a_limit_small(small_cell, name):
    cell = small_cell(name)
    for seed in SEEDS[:2]:
        r = calibrate.readings(cell, seed, "cpu", control=True)
        assert _holds(cell, r["program"]), r["program"]
        assert not _holds(cell, r["control"]), r["control"]
        for fault, numbers in r["faults"].items():
            if fault != "stalled":
                assert not _holds(cell, numbers), (fault, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_breaks_a_limit_on_card(bench, name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    from nmfbench.harness import spec

    cell = spec.resolve(bench, name)
    for seed in SEEDS:
        r = calibrate.readings(cell, seed, "cuda", control=True)
        assert _holds(cell, r["program"]), r["program"]
        assert not _holds(cell, r["control"]), r["control"]
        for fault, numbers in r["faults"].items():
            assert not _holds(cell, numbers), (fault, numbers)
