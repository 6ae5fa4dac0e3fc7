"""Tests of the benchmark (run: ``python -m pytest nmfbench/tests``).

CPU tests use small copies of the configurations; tests marked ``cuda``
run the cell-size readings on an NVIDIA GPU and skip elsewhere, deciding
inside the test.  Nothing here imports jax or tpunmf.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a small copy of each cell's shape, for the CPU; ADMM KL at a hundredth
# of its cell (rank 50 kept), since below that its f32 and float64
# trajectories part within 100 iterations, and MUR KL where its control's
# gap reaches the cell's limit (PERF.md)
SMALL = {"tfidf-20news.mur-kl": ({"m": 1000, "n": 600}, 20),
         "tfidf-20news.admm-kl": ({"m": 2000, "n": 1100}, 50)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (tpunmf_torch kernels); skips elsewhere")


@pytest.fixture(scope="session")
def bench():
    from nmfbench.harness import spec

    return spec.load_benchmark()


@pytest.fixture(scope="session")
def small_cell(bench):
    """small_cell(name): the cell with its configuration cut to SMALL."""
    from nmfbench.harness import spec

    def make(name):
        entry = next(w for w in bench["workloads"] if w["name"] == name)
        config = json.loads((ROOT / next(c["file"] for c in bench["configs"]
                                         if c["name"] == entry["config"])).read_text())
        config["shape"], config["rank"] = SMALL[name]
        return spec.resolve(bench, name, config=config)

    return make

