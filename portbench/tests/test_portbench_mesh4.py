"""The four-card capture, cornell-box.capture-100spp.mesh4, on four gloo
ranks on the CPU at a small size: its answers read correct against the
single-card capture's reference, the collectives move the bytes the
shapes give, and the NCCL reader finds nothing to read on gloo."""

import time

from portbench import harness
from portbench import run as bench_run
from tracer_tpu_torch.utils import profiling

BENCH = harness.manifest()
CELL = "cornell-box.capture-100spp.mesh4"


def reduce_bytes(width, height, spp, mesh):
    """Bytes one rank all-reduces in one call of sample_points_sharded:
    the merge's best distance (f32) and winner (int32) and its (4, N)
    f32 point over the tile's N pixels, then the (h, w, 4) f32 frame."""
    n_tile, _ = mesh
    n = height // n_tile * width
    return 4 * n + 4 * n + 4 * 4 * n + 4 * height * width * 4


def test_the_cell_and_its_mix():
    cell = harness.Cell(BENCH, CELL)
    assert (cell.chips, cell.entry["config"], cell.entry["traffic"]) == (
        4, "cornell-box", "capture-100spp.mesh2x2")
    mix = cell.traffic
    assert mix["entry"] == "sample_points_sharded"
    assert (mix["width"], mix["height"], mix["spp"], mix["sensor_config"],
            mix["mesh"]) == (640, 480, 100, 2, [2, 2])
    single = harness.Cell(BENCH, "cornell-box.capture-100spp")
    assert cell.check == single.check
    assert reduce_bytes(640, 480, 100, mix["mesh"]) == 8_601_600
    assert {m["name"] for m in cell.per_layer} == {
        "mesh.reduce_device_ms_per_call", "device.busy_pct.offline",
        "pool.ms_per_iter.offline"}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "msamples_per_s"}


def test_four_gloo_ranks_are_correct_and_reduce_the_shapes_bytes():
    """A traced run of a few calls: the check's two calls, on nonces
    the entry advanced, read correct; the profiled call's collectives
    move the shapes' bytes."""
    cell = harness.Cell(BENCH, CELL)
    mix = dict(cell.traffic, width=32, height=24, spp=16)
    profiling.reset()
    try:
        r = bench_run.run_cell(cell, 2_718_281_828, 2.0, True, "cpu",
                               time.perf_counter(), "cpu", mix)
        counted = profiling.counters().get("mesh.reduce_bytes")
    finally:
        profiling.reset()
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4 and r["attempted"] >= 2
    # the recorder is on for the profiled call alone: one call's bytes
    assert counted == reduce_bytes(32, 24, 16, mix["mesh"]) == 21_504
    assert "mesh.reduce_device_ms_per_call" not in r["metrics"]
    assert "pool.ms_per_iter.offline" in r["metrics"]
