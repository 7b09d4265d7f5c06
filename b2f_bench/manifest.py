"""The benchmark's data, found by name: `BENCHMARK.json` at the root of
the checkout, and under `b2f_bench/` a file for each configuration
(`configs/<config>.json`, named in BENCHMARK.json), traffic mix
(`traffic/<traffic>.json`), cell (`workloads/<cell>.json`: the limits of
its correctness check), traffic kind (`kinds/<kind>.py`), reference
(`reference/<name>.py`) and per-layer metric family
(`metrics/<family>.py`, for the metric names `<family>` and
`<family>.<part>`). The data files are read from the checkout given as
`root`, the modules imported from this package. Adding any of them is
adding a file and an entry; no code names them.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PACKAGE = "b2f_bench"


@dataclasses.dataclass
class Cell:
    """One cell of BENCHMARK.json with everything its run reads."""
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: Dict[str, float]   # workloads/<cell>.json
    end_to_end: List[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]
    root: Path

    @property
    def options(self) -> dict:
        """The program's options: the configuration's, then the mix's."""
        return {**self.config["options"], **self.traffic.get("options", {})}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of the benchmark at `root`; raises KeyError for a
    cell that BENCHMARK.json does not hold."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[entry["config"]]["file"])
    traffic = read_json(root / PACKAGE / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(root / PACKAGE / "workloads" / f"{name}.json")["limits"]
    return Cell(name=name, chips=entry["chips"], config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)], root=root)


def load_module(folder: str, name: str) -> ModuleType:
    """The module `b2f_bench/<folder>/<name>.py`, imported by that name."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"{folder} name {name!r}: letters, digits and _ only")
    return importlib.import_module(f"{PACKAGE}.{folder}.{name}")


def metric_reader(cell: Cell, metric: str):
    """The reader function of a per-layer metric and the part of its
    name after the family: `<family>.<part>` -> (metrics/<family>.py
    `read`, "<part>"); a name without a dot has the part None."""
    family, _, part = metric.partition(".")
    return load_module("metrics", family).read, (part or None)


def reference(cell: Cell) -> ModuleType:
    return load_module("reference", cell.config["reference"])


def kind(cell: Cell) -> ModuleType:
    return load_module("kinds", cell.traffic["kind"])
