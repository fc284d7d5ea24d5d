"""A cell, a traffic mix, a metric, a scene and an entry of the program
are found by name: added to a copy of the benchmark as files and
BENCHMARK.json entries only, they run, on the ranks the cell's chips
ask for. And the command refuses to run without a card."""

import json
import shutil
import subprocess
import sys
import time

from portbench import harness
from portbench import run as bench_run

ROOT = harness.ROOT


SCENE = """
import numpy as np
from portbench.reference.scene import mat_row, quad


def build():
    tris = (quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1])
            + quad([-0.3, 1.5, 0.3], [-0.3, 1.5, -0.3], [0.3, 1.5, -0.3],
                   [0.3, 1.5, 0.3]))
    mats = np.stack([mat_row(kd=(0.7, 0.6, 0.5)), mat_row(ke=(9, 8, 7))])
    return (np.asarray(tris, np.float32), np.asarray([0, 0, 1, 1],
            np.uint32), mats)
"""

ENTRY = """
import numpy as np
from portbench import check
from portbench.drive import MASK

KIND = "offline"


class Traffic:
    def __init__(self, mix, config, scene, seed, device, ranks):
        from tracer_tpu_torch.engine import api
        from tracer_tpu_torch.parallel import render as par
        self.par, self.spp = par, int(mix["spp"])
        self.mesh = par.make_mesh(ranks[1], 1)
        self.state = api.init(int(seed), int(mix["height"]),
                              int(mix["width"]), int(mix["sensor_config"]),
                              *scene, cam_origin=tuple(
                                  config["camera"]["origin"]),
                              accel=config["accel"], device=device)

    def call(self, i):
        import dataclasses
        nonce = (0x40000000 if i is None else i * self.spp) & MASK
        s = dataclasses.replace(self.state, nonce=nonce)
        img = self.par.render_pooled_sharded(s, self.mesh, self.spp)
        return {"nonce": nonce, "out": img.cpu().numpy()}

    def final(self):
        return {}


def numbers(run, settings, want, got=None):
    gaps = [check.pixel_gaps(run.calls[c]["out"].reshape(-1, 3)[px],
                             want.render(run.calls[c]["nonce"], px))
            for c, px in zip(*check.picks(run, settings, want.seed))]
    return {"off_share": check.off_share(np.concatenate(gaps))}


def control_run(run, calls, frames):
    run.calls = [{"nonce": (i * run.spp) & MASK} for i in range(calls)]
"""


def copy_bench(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "portbench", json.loads(
        (ROOT / "BENCHMARK.json").read_text())


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    base, bench = copy_bench(tmp_path)
    (base / "traffic" / "render-2spp.json").write_text(json.dumps(
        {"entry": "sample_n_frames", "width": 10, "height": 6, "spp": 2,
         "sensor_config": 0, "warmup_calls": 1}))
    (base / "workloads" / "cornell-box.render-2spp.json").write_text(
        json.dumps({"calls": 1, "pixels": 16,
                    "limits": {"gap_p90": 1e-4, "off_share": 0.03}}))
    (base / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    bench["workloads"].append({"name": "cornell-box.render-2spp",
                               "config": "cornell-box",
                               "traffic": "render-2spp", "chips": 1,
                               "why": "a small render"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "integrator",
                               "moves": "msamples_per_s",
                               "workloads": ["cornell-box.render-2spp"]})
    for m in bench["end_to_end"]:
        if m["name"] == "msamples_per_s":
            m["workloads"].append("cornell-box.render-2spp")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(harness.manifest(tmp_path), "cornell-box.render-2spp",
                        base)
    assert cell.traffic["spp"] == 2
    assert [m["name"] for m in cell.per_layer] == ["calls_in_window"]
    r = bench_run.run_cell(cell, 7, 0.0, False, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "msamples_per_s"}
    assert harness.reader("calls_in_window", base)(
        type("R", (), {"calls": [1, 2]})) == 2


def test_new_scene_and_entry_on_two_ranks_are_found_by_name(tmp_path):
    """A scene generator, an entry of the program (the tile-sharded
    render of parallel/render.py) and a cell on two ranks, added as
    files: the cell's chips start a process group of two (gloo on the
    CPU), and its answers read correct."""
    base, bench = copy_bench(tmp_path)
    (base / "scenes" / "floor_light.py").write_text(SCENE)
    (base / "entries" / "render_tiles.py").write_text(ENTRY)
    (base / "configs" / "floor-light.json").write_text(json.dumps(
        {"name": "floor-light", "scene": {"generator": "floor_light"},
         "camera": {"origin": [0.0, 0.8, 1.8]}, "accel": "auto"}))
    (base / "traffic" / "tiles-2spp.json").write_text(json.dumps(
        {"entry": "render_tiles", "width": 6, "height": 8, "spp": 2,
         "sensor_config": 0, "warmup_calls": 1}))
    (base / "workloads" / "floor-light.tiles-2spp.json").write_text(
        json.dumps({"calls": 2, "pixels": 12, "limits": {"off_share": 0.0}}))
    bench["configs"].append({"name": "floor-light", "source": "a test",
                             "file": "portbench/configs/floor-light.json",
                             "reduced": [], "why": "a test scene"})
    bench["workloads"].append({"name": "floor-light.tiles-2spp",
                               "config": "floor-light",
                               "traffic": "tiles-2spp", "chips": 2,
                               "why": "rows over two ranks"})
    for m in bench["end_to_end"]:
        if m["name"] == "msamples_per_s":
            m["workloads"].append("floor-light.tiles-2spp")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(harness.manifest(tmp_path), "floor-light.tiles-2spp",
                        base)
    assert cell.chips == 2
    r = bench_run.run_cell(cell, 11, 0.5, False, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 2 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "msamples_per_s"}


def test_no_card_no_result(tmp_path):
    """Without a CUDA card (this host), and in a directory that holds
    only BENCHMARK.json and portbench/, the command prints no result
    and exits non-zero."""
    copy_bench(tmp_path)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for where in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "cornell-box.render-256spp", "--seed", "5", "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            timeout=300)
        assert p.returncode != 0
        assert p.stdout.strip() == ""
