"""BENCHMARK.json against the benchmark's contract, and every file it
names present."""

import json
import math
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    for w in BENCH["workloads"]:
        assert TEXT.match(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])


def test_entry_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}
    for key, keys in allowed.items():
        for e in BENCH[key]:
            assert set(e) <= keys and keys - {"workloads"} <= set(e), e


def test_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    c = harness.Cell(BENCH, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in
                                  harness.Cell(BENCH, w).end_to_end}


def test_files_named_exist_and_cells_use_every_config():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("portbench/") and (ROOT / f).is_file()
        assert json.loads((ROOT / f).read_text())["name"]
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert (ROOT / "portbench" / "workloads" / f"{w['name']}.json"
                ).is_file()
        assert w["chips"] in (1, 4)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(BENCH["workloads"])))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
