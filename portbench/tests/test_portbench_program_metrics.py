"""The per-layer metrics read from the program's own recorder
(tracer_tpu_torch.utils.profiling): nothing on an untraced run or on a
recorder that did not record the traced stretch alone, the right value on
a recorder filled over a small CPU call of each entry, and non-null in a
whole traced run of each kind of cell on the CPU."""

import time

import pytest

from portbench import drive, harness, program
from portbench import run as bench_run
from portbench.reference import scene as scene_mod

from tracer_tpu_torch.utils import profiling

OFFLINE = ("pool.live_pct.offline", "host.wait_pct.offline")
VIEWER = ("pool.live_pct.viewer", "host.wait_pct.viewer",
          "pool.outside_ms.viewer")
READERS = OFFLINE + VIEWER
BENCH = harness.manifest()
CONFIG = harness.load_json(harness.ROOT / "portbench" / "configs"
                           / "cornell-box.json")
MIXES = {
    "sample_n_frames": {"entry": "sample_n_frames", "width": 10,
                        "height": 6, "spp": 3, "sensor_config": 0},
    "sample_points_n": {"entry": "sample_points_n", "width": 10,
                        "height": 6, "spp": 2, "sensor_config": 2},
    "step_render": {"entry": "step_render", "width": 10, "height": 6,
                    "spp": 1, "sensor_config": 0, "keys": ["m"]}}


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def read(name, run):
    return harness.reader(name)(run)


def recorded_call(entry, calls=1):
    """A Run of the entry's small mix whose traced stretch is `calls`
    calls made under profiling.tracing(), as the profiler makes them in
    a traced run; and render_pooled's outputs of the stretch."""
    from tracer_tpu_torch.engine import integrator
    scene = scene_mod.build(CONFIG)
    traffic, run = drive.start(MIXES[entry], CONFIG, scene, 7, "cpu")
    outs = []
    keep = drive.Wrap(integrator, "render_pooled",
                      lambda out, *a, **k: outs.append(out))
    with keep, drive.count_iters(run), profiling.tracing():
        for _ in range(calls):
            traffic.call(None)
    run.trace = {"iters": sum(run.iters)}
    return run, outs


@pytest.mark.parametrize("name", READERS)
def test_nothing_on_an_untraced_run(name):
    run = drive.Run("sample_n_frames", "offline", 4, 2, 3, 24)
    assert read(name, run) is None
    run.kind = "frames"
    assert read(name, run) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_when_the_recorder_saw_another_stretch(name):
    entry = "step_render" if name in VIEWER else "sample_n_frames"
    run, _ = recorded_call(entry)
    assert read(name, run) is not None
    run.trace["iters"] += 1
    assert read(name, run) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_the_recorder(name, monkeypatch):
    """The parent of the recorder's change: the module has no counters or
    summary, and the readers give None without raising."""
    entry = "step_render" if name in VIEWER else "sample_n_frames"
    run, _ = recorded_call(entry)
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.delattr(profiling, "summary")
    assert read(name, run) is None


@pytest.mark.parametrize("entry", ["sample_n_frames", "sample_points_n"])
def test_offline_values(entry):
    run, outs = recorded_call(entry)
    (out,) = outs
    assert read("pool.live_pct.offline", run) == pytest.approx(
        100.0 * out["rays_traced"] / 3 / (out["lanes"] * out["iters"]))
    s = profiling.summary()
    api = s[f"api.{entry}"]["total_s"]
    reads = (s["host.read.pool.exit"]["total_s"]
             + s["host.read.pool.counts"]["total_s"])
    assert read("host.wait_pct.offline", run) == pytest.approx(
        100.0 * reads / api)
    assert 0 < read("host.wait_pct.offline", run) < 100
    for name in VIEWER:
        assert read(name, run) is None


def test_viewer_values():
    run, outs = recorded_call("step_render", calls=3)
    live = sum(o["rays_traced"] // 3 for o in outs)
    lane_iters = sum(o["lanes"] * o["iters"] for o in outs)
    assert read("pool.live_pct.viewer", run) == pytest.approx(
        100.0 * live / lane_iters)
    s = profiling.summary()
    api = s["api.step"]["total_s"] + s["api.render"]["total_s"]
    reads = sum(v["total_s"] for k, v in s.items()
                if k.startswith("host.read."))
    assert read("host.wait_pct.viewer", run) == pytest.approx(
        100.0 * reads / api)
    assert s["api.step"]["count"] == 3
    outside = read("pool.outside_ms.viewer", run)
    assert outside == pytest.approx(
        1e3 * (api - s["pool.iter"]["total_s"]) / 3)
    assert 0 < outside < 1e3 * api / 3
    assert program.total_s(s, "host.read.") == pytest.approx(reads)
    for name in OFFLINE:
        assert read(name, run) is None


@pytest.mark.parametrize("cell,mix", [
    ("cornell-box.render-256spp", "sample_n_frames"),
    ("cornell-box.viewer-800x600", "step_render")])
def test_a_traced_run_reports_them(cell, mix):
    """A whole traced run on the CPU, the profiler and all: the recorder
    is on for the profiled stretch alone, and every new metric of the
    cell reads a number."""
    c = harness.Cell(BENCH, cell)
    names = {m["name"] for m in c.per_layer} & set(READERS)
    assert names == set(OFFLINE if mix == "sample_n_frames" else VIEWER)
    settings = {"calls": 1, "pixels": 8, "limits": c.check["limits"]}
    r = bench_run.run_cell(c, 5, 0.0, True, "cpu", time.perf_counter(),
                           mix={**MIXES[mix], "warmup_calls": 1},
                           settings=settings)
    assert r["correct"], r["checks"]
    for name in names:
        assert name in r["metrics"], (name, r["metrics"])
        assert r["metrics"][name]["value"] >= 0.0


def test_the_manifest_names_the_five_metrics():
    """Each of the five names the box's cells of its kind among its
    workloads (a later cell may join them), with its source, the metric
    it moves and its layer."""
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    offline = ["cornell-box.render-256spp", "cornell-box.capture-100spp"]
    viewer = ["cornell-box.viewer-800x600"]
    want = {"pool.live_pct.offline": ("program_counter", "msamples_per_s",
                                      offline),
            "pool.live_pct.viewer": ("program_counter", "frame_ms_p90",
                                     viewer),
            "host.wait_pct.offline": ("program_span", "msamples_per_s",
                                      offline),
            "host.wait_pct.viewer": ("program_span", "frame_ms_p90", viewer),
            "pool.outside_ms.viewer": ("program_span", "frame_ms_p90",
                                       viewer)}
    for name, (source, moves, cells) in want.items():
        m = per_layer[name]
        assert (m["source"], m["moves"], m["layer"]) == (
            source, moves, "integrator")
        assert set(cells) <= set(m["workloads"]), (name, m["workloads"])
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()
