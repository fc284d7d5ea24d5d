"""The metrics' arithmetic on made-up runs: a rate over whole calls, a
percentile over all frames, the busy union, the check's gaps."""

import math

import numpy as np
import pytest

from portbench import check, drive, harness, trace


def offline_run():
    run = drive.Run("sample_n_frames", "offline", 4, 2, 3, 24)
    run.window_start = 10.0
    run.calls = [{"t0": 10.0, "t1": 11.0}, {"t0": 11.0, "t1": 12.5},
                 {"t0": 12.5, "t1": 14.0}]
    run.iters = [5, 5, 6, 7]   # the last is a traced call's, not the window's
    run.trace = {"busy_s": 0.25, "window_s": 1.0, "device_ops": 120,
                 "iters": 6, "op_device_s": {"closest": 0.5, "any": 0.0},
                 "bound_s": {"closest": 0.01, "any": 0.01}}
    return run


def viewer_run(ms):
    run = drive.Run("step_render", "frames", 4, 2, 1, 8)
    run.window_start = 0.0
    t, calls = 0.0, []
    for m in ms:
        calls.append({"t0": t, "t1": t + m / 1e3, "step_s": m / 2e3,
                      "present_s": 0.001})
        t += m / 1e3
    run.calls, run.iters = calls, [2] * len(ms)
    run.trace = {"busy_s": 0.5, "window_s": 2.0}
    return run


def read(name, run):
    return harness.reader(name)(run)


def test_rate_over_whole_calls():
    run = offline_run()
    assert read("msamples_per_s", run) == pytest.approx(3 * 24 / 4.0 / 1e6)
    assert read("frames_per_s", run) is None
    assert read("pool.ms_per_iter.offline", run) == pytest.approx(
        1e3 * 4.0 / 16)
    assert read("device.busy_pct.offline", run) == pytest.approx(25.0)
    assert read("bounce.device_ops_per_iter", run) == pytest.approx(20.0)
    assert read("closest_hit_roofline", run) == pytest.approx(2.0)
    assert read("any_hit_roofline", run) is None   # no device time: nothing


def test_p90_over_all_frames():
    ms = list(range(1, 21))            # 20 frames of 1..20 ms
    run = viewer_run(ms)
    assert read("frame_ms_p90", run) == pytest.approx(18.0)
    assert read("frames_per_s", run) == pytest.approx(20 / (sum(ms) / 1e3))
    assert read("viewer.present_ms", run) == pytest.approx(1.0)
    assert read("pool.ms_per_iter.viewer", run) == pytest.approx(
        sum(ms) / 2 / 40)
    assert read("device.busy_pct.viewer", run) == pytest.approx(25.0)
    assert read("msamples_per_s", run) is None
    run = viewer_run([5.0] * 9 + [100.0])
    assert read("frame_ms_p90", run) == pytest.approx(5.0)
    run = viewer_run([5.0] * 8 + [100.0] * 2)
    assert read("frame_ms_p90", run) == pytest.approx(100.0)


def test_busy_union_counts_overlaps_once():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert trace.union(spans) == [[0, 15], [20, 30], [40, 41]]
    assert sum(b - a for a, b in trace.union(spans)) == 26


def test_check_gaps_p90_and_off_share():
    assert check.p90(np.arange(1, 11)) == 9
    assert math.isinf(check.p90([]))
    assert check.off_share([3e-7, 2.0, 1e-7, float("nan")]) == 0.5
    assert check.off_share([3e-7, 0.0], [False, True]) == 0.5
    assert math.isinf(check.off_share([]))
    want = np.array([[1.0, 0.5, 0.0], [0.0, 0.0, 0.0]], np.float32)
    got = np.array([[1.001, 0.5, 0.0], [0.0, 0.0, 0.0]], np.float32)
    g = check.pixel_gaps(got, want)
    assert g[0] == pytest.approx(1e-3, rel=1e-3) and g[1] == 0
    none = [-1.0, -1.0, -1.0, 0.0]
    want = np.array([[0, 1, 0, 2.0], none, [0, 0, -2, 1.0]])
    got = np.array([[0, 1.001, 0, 2.0], none, none])
    g, one = check.point_gaps(got, want, (0.0, 0.0, 0.0))
    assert g[0] == pytest.approx(1e-3) and g[1] == 0 and g[2] == 0
    assert one.tolist() == [False, False, True]
    assert not check.correct({"gap_p90": (float("nan"), 1.0)})
    assert check.correct({"gap_p90": (0.5, 1.0)})
