"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (``configs`` entry: its ``file``) and a
traffic mix (``traffic/<traffic>.json``); the mix names a method, whose
work count is ``work/<method>.py`` and whose plain reference is
``reference/<method>.py``; the configuration names a generator
(``generators/<generator>.py``); the numbers the cell compares, their
limits and the readings they were set from are ``limits/<cell>.json``;
a metric, end to end or per layer, is read by ``metrics/<metric>.py``.
Adding a cell or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    """``nmfbench/<kind>/<name>.json``."""
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``nmfbench/<kind>/<name>.py`` as a module (a name may hold ``.`` and
    ``-``, which a module name may not)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    modname = f"nmfbench.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[modname] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def method(self) -> str:
        return self.traffic["method"]

    @property
    def limits(self) -> dict:
        return self.check["limits"]

    @property
    def rank(self) -> int:
        return int(self.config["rank"])

    def generator(self):
        return load_module("generators", self.config["generator"])

    def work(self):
        return load_module("work", self.method)

    def reference(self):
        return load_module("reference", self.method)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, cell_name: str, *, config=None) -> Cell:
    """The cell called ``cell_name``; ``config`` replaces its configuration
    (a test's smaller copy)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r}; BENCHMARK.json has {sorted(cells)}")
    entry = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    if config is None:
        with open(ROOT / configs[entry["config"]]["file"]) as f:
            config = json.load(f)
    return Cell(
        name=cell_name,
        chips=int(entry["chips"]),
        config=config,
        traffic=load_json("traffic", entry["traffic"]),
        check=load_json("limits", cell_name),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, cell_name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, cell_name)],
    )
