"""What the benchmark reads by name: BENCHMARK.json at the checkout's
root, a configuration's file, a traffic mix, a cell's check settings and
the metric readers.

  configs/<config>.json    the scene, the camera and the guarantees
  scenes/<generator>.py    build() -> (tris, tri_mats, mats), which a
                           configuration's "scene" names
  traffic/<traffic>.json   the traffic mix the generator (drive.py) runs
  entries/<entry>.py       the program's entry a mix names: its calls
                           and what the check compares of their answers
  workloads/<cell>.json    how many answers the check samples, and limits
  metrics/<metric>.py      one reader per metric: read(run) -> float|None

A later cell, mix or metric is new files and BENCHMARK.json entries; no
file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


class Cell:
    """One entry of BENCHMARK.json's workloads with everything it names:
    its configuration, its traffic mix, its check settings and the
    metrics it reports with and without --trace."""

    def __init__(self, bench: dict, name: str, base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(known: {sorted(cells)})")
        self.name = name
        self.base = base
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(base.parent / self.config_entry["file"])
        self.traffic = load_json(base / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.check = load_json(base / "workloads" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def module(folder: str, name: str, base: Path = HERE):
    """The module <folder>/<name>.py of the benchmark at `base`, loaded
    once."""
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r} in {folder}/")
    key = (f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
           + f"_{abs(hash(str(base))):x}")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, base / folder / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def reader(metric: str, base: Path = HERE):
    """The read(run) function of metrics/<metric>.py."""
    return module("metrics", metric, base).read


def entry(name: str, base: Path = HERE):
    """The module of entries/<name>.py: Traffic, numbers, control_run."""
    return module("entries", name, base)
