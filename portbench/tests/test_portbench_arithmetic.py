"""The metrics' arithmetic on made-up runs: a rate over whole calls, a
percentile over all frames, the busy union, the profiler's events
reduced, the collectives' device time, the check's gaps."""

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


class Event:
    """One raw profiler event as trace.reduce reads it."""

    def __init__(self, device, name, start, end, corr=0, link=0):
        self.device, self.n, self.a, self.b = device, name, start, end
        self.corr, self.link = corr, link

    def device_type(self):
        return self.device

    def name(self):
        return self.n

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link


def reduced(events):
    from types import SimpleNamespace
    results = SimpleNamespace(events=lambda: events)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
    return trace.reduce(prof, 1e-3)


def test_reduce_reads_the_collectives_apart_and_the_rest_as_before():
    """An NCCL kernel counts in busy, device ops and the breakdown as
    any op does, and its device time alone in collective_s; c10d's
    device annotation that mirrors it counts there once, as before, and
    not in collective_s."""
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        Event(cpu, "tracer_tpu_torch::closest_hit", 0, 100, corr=1),
        Event(cpu, "cudaLaunchKernel", 10, 20, corr=2),
        Event(cuda, "closest_hit_kernel", 50, 150, link=2),
        Event(cuda, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 140, 400),
        Event(cuda, "ncclDevKernel_AllReduce_Max_i32_RING_LL(x)", 500, 530),
        Event(cuda, "nccl:all_reduce", 499, 531),
        Event(cuda, "elementwise_kernel", 600, 610)]
    r = reduced(events)
    assert r["busy_s"] == pytest.approx((400 - 50 + 32 + 10) * 1e-9)
    assert r["device_ops"] == 5 and r["window_s"] == 1e-3
    assert r["op_device_s"] == {"closest": pytest.approx(100e-9),
                                "any": 0.0}
    assert r["collective_s"] == pytest.approx((260 + 30) * 1e-9)
    assert r["breakdown"]["device_ops"][0] == [
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", pytest.approx(260e-9)]
    assert reduced(events[:3] + events[-1:])["collective_s"] == 0.0


def test_reduce_leaves_out_the_ranks_barrier():
    """Device ops that ended before the ALIGN span closed (the ranks'
    barrier before the stretch, which waits out the profiler's start)
    count nowhere; the stretch's ops count as they would alone."""
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    stretch = [
        Event(cpu, "cudaLaunchKernel", 210, 220, corr=2),
        Event(cuda, "elementwise_kernel", 250, 300, link=2),
        Event(cuda, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 300, 380),
        Event(cuda, "elementwise_kernel", 400, 410)]
    barrier = [
        Event(cpu, trace.ALIGN, 0, 200),
        Event(cuda, "Memcpy HtoD (Pageable -> Device)", 5, 6),
        Event(cuda, "ncclDevKernel_AllReduce_Max_f64_RING_LL(x)", 10, 190),
        Event(cuda, "Memcpy DtoH (Device -> Pageable)", 191, 192)]
    alone, after = reduced(stretch), reduced(barrier + stretch)
    assert after["collective_s"] == pytest.approx(80e-9)
    for k in ("busy_s", "device_ops", "collective_s", "breakdown"):
        assert after[k] == alone[k], k


def test_collectives_ms_per_call():
    run = offline_run()
    assert read("mesh.reduce_device_ms_per_call", run) is None  # none ran
    run.trace["collective_s"] = 0.0
    assert read("mesh.reduce_device_ms_per_call", run) is None
    run.trace["collective_s"] = 0.0125
    assert read("mesh.reduce_device_ms_per_call", run) == pytest.approx(12.5)
    assert read("mesh.reduce_device_ms_per_call", viewer_run([5.0])) is None


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
