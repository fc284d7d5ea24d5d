"""The span-and-counter recorder of tracer_tpu_torch/utils/profiling.py
and its places in the program: off it records nothing and changes no
bit; spans nest with the right self times and reach torch.profiler as
host ops; the pool's counters and host reads agree with render_pooled's
own outputs; an export records nothing."""

import dataclasses
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tracer_tpu_torch as T
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.utils import aot, profiling, testscenes

torch.set_num_threads(2)

ORIGIN = (0.0, 0.8, 1.8)
H, W = 12, 16


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _state(conf=0, accel="auto", h=H, w=W):
    return T.init(5, h, w, conf, *testscenes.cornell_like(),
                  cam_origin=ORIGIN, accel=accel, device="cpu")


def _pooled(s, spp, with_points=False):
    return tint.render_pooled(s.seed, s.nonce, s.scene, s.cam, s.ambience,
                              s.width, s.height, s.transmitter_kind, spp,
                              s.render_mode, with_points=with_points)


@pytest.mark.parametrize("accel", ["auto", "lbvh"])
def test_off_records_nothing_and_changes_no_bit(accel):
    s = _state(2, accel)
    assert not profiling.active()
    assert profiling.span("a") is profiling.span("b")    # one no-op object
    off = _pooled(s, 3, with_points=True)
    assert profiling.summary() == {} and profiling.counters() == {}
    assert profiling.spans() == []
    with profiling.tracing():
        assert profiling.active()
        on = _pooled(s, 3, with_points=True)
    assert not profiling.active()
    assert torch.equal(on["img"], off["img"])
    for a, b in zip(on["points"], off["points"]):
        assert torch.equal(a, b)
    assert (on["rays_traced"], on["iters"]) == (off["rays_traced"],
                                                off["iters"])
    assert profiling.summary()["pool.iter"]["count"] == on["iters"]
    if accel == "lbvh":
        c = profiling.counters()
        assert c["host.reads.lbvh.exit"] > 0
        assert profiling.summary()["lbvh.iter"]["count"] > 0


def test_nested_spans_give_self_times():
    with profiling.tracing():
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.004)
                with profiling.span("leaf"):
                    time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.001)
    s = profiling.summary()
    assert {k: v["count"] for k, v in s.items()} == {"outer": 1, "inner": 2,
                                                    "leaf": 1}
    assert s["leaf"]["self_s"] == s["leaf"]["total_s"] >= 0.002
    assert s["inner"]["self_s"] == pytest.approx(
        s["inner"]["total_s"] - s["leaf"]["total_s"], abs=1e-9)
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["total_s"] - s["inner"]["total_s"], abs=1e-9)
    assert s["outer"]["self_s"] >= 0.002
    spans = profiling.spans()
    assert [(n, p) for n, _, _, p in spans] == [
        ("outer", -1), ("inner", 0), ("leaf", 1), ("inner", 0)]
    for _, a, b, _ in spans:
        assert a <= b


def test_counters_accumulate_only_while_on():
    profiling.count("c", 5)
    with profiling.host_read("x"):
        pass
    assert profiling.counters() == {}
    with profiling.tracing():
        profiling.count("c")
        with profiling.tracing():       # nested: still on, once
            profiling.count("c", 2)
        profiling.count("c", 3)
        with profiling.host_read("x"):
            pass
    profiling.count("c", 100)
    assert profiling.counters() == {"c": 6, "host.reads": 1,
                                    "host.reads.x": 1}
    assert profiling.summary()["host.read.x"]["count"] == 1


def test_spans_are_host_ops_of_the_profiler(tmp_path):
    """Under a CPU profiler session the recorder is on by itself, and its
    spans are cpu_op events of their names: no user annotation, which on
    a CUDA profile would gain a device mirror."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.active()
        with profiling.span("test.outer"):
            with profiling.host_read("test"):
                torch.ones(8).sum()
    assert not profiling.active()
    names = ("test.outer", "host.read.test")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    assert sorted(e.name() for e in events) == sorted(names)
    for e in events:
        assert e.device_type() == torch.autograd.DeviceType.CPU
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    rows = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sorted(e["cat"] for e in rows if e.get("name") in names) == [
        "cpu_op", "cpu_op"]
    assert not [e for e in rows if "annotation" in str(e.get("cat"))]
    assert profiling.counters() == {"host.reads": 1, "host.reads.test": 1}


@pytest.mark.parametrize("conf,spp", [(0, 4), (2, 3)])
def test_pool_counters_match_render_outputs(conf, spp):
    s = _state(conf)
    with profiling.tracing():
        out = _pooled(s, spp, with_points=conf == 2)
    c = profiling.counters()
    assert out["lanes"] == tint._pool_size(W * H, spp, 8)
    assert c["pool.iters"] == out["iters"]
    assert c["pool.lane_iters"] == out["lanes"] * out["iters"]
    assert c["pool.live_lanes"] / c["pool.lane_iters"] == \
        out["rays_traced"] / 3 / (out["lanes"] * out["iters"])
    assert 0 < c["pool.live_lanes"] <= c["pool.lane_iters"]


def test_host_reads_are_the_exit_checks_and_the_count(monkeypatch):
    """The pool tests its exit on the host from full_iters on, once per
    iteration and once more where it stops; render_pooled reads its
    counts once."""
    s = _state(0, h=24, w=32)
    spp, lanes = 4, 1000
    # several refills before the drain
    monkeypatch.setattr(tint, "POOL_LANES_RESIDENT", lanes)
    with profiling.tracing():
        out = _pooled(s, spp)
    full_iters = -(-(24 * 32 * spp) // lanes)
    checks = out["iters"] - full_iters + 1
    c = profiling.counters()
    assert out["lanes"] == lanes and full_iters > 1
    assert c["host.reads.pool.exit"] == checks
    assert c["host.reads.pool.counts"] == 1
    assert c["host.reads"] == checks + 1
    summ = profiling.summary()
    assert summ["pool.iter"]["count"] == out["iters"]
    for name in ("bounce.refill", "bounce.closest", "bounce.shade",
                 "bounce.shadow", "bounce.finish", "bounce.store"):
        assert summ[name]["count"] == out["iters"]
    assert summ["pool.round"]["count"] == 1


def test_api_spans_and_the_lbvh_walk():
    s = _state(0, accel="lbvh")
    with profiling.tracing():
        s = T.step(s)
        T.render(s)
        T.sample_n_frames(s, 3)
        T.sample_points_n(dataclasses.replace(s, nonce=0), 1)
    summ = profiling.summary()
    for name in ("api.step", "api.render", "api.sample_n_frames",
                 "api.sample_points_n"):
        assert summ[name]["count"] == 1
    assert summ["lbvh.iter"]["count"] > 0
    c = profiling.counters()
    assert c["host.reads.lbvh.exit"] > 0
    assert c["host.reads"] == sum(v for k, v in c.items()
                                  if k.startswith("host.reads."))
    # every api span is a root; the pool's spans lie inside them
    spans = profiling.spans()
    roots = {n for n, _, _, p in spans if p < 0}
    assert roots == {"api.step", "api.render", "api.sample_n_frames",
                     "api.sample_points_n"}


def test_export_records_nothing_and_steps_to_the_same_bits():
    """utils/aot.py's export of the step, under tracing(): the traced
    program's spans and counts are no-ops, and the loaded step gives
    api.step's bits, with one host read of its counters."""
    s = T.step(dataclasses.replace(_state(0, h=10, w=12), mode=True))
    with profiling.tracing():
        blob = aot.export_step(s)
    assert profiling.summary() == {} and profiling.counters() == {}
    step = aot.load(blob)
    with profiling.tracing():
        got = step(s)
    assert profiling.counters() == {"host.reads": 1,
                                    "host.reads.aot.counters": 1}
    want = T.step(s)
    assert torch.equal(got.img, want.img)
    assert (got.n_frames, got.nonce) == (want.n_frames, want.nonce)


def test_compiling_turns_the_recorder_off(monkeypatch):
    """While torch.export or torch.compile traces the program (here: as
    they report it), spans and counts are no-ops whatever the flags."""
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with profiling.tracing():
        assert not profiling.active()
        assert profiling.span("x") is profiling.span("y")
        with profiling.span("x"):
            profiling.count("c")
    assert profiling.summary() == {} and profiling.counters() == {}


def test_span_store_bound_drops_into_a_counter(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 3)
    with profiling.tracing():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3
    assert profiling.counters() == {"spans.dropped": 2}
    assert profiling.summary()["s"]["count"] == 5


def test_device_trace_writes_spans_beside_the_trace(tmp_path):
    with profiling.device_trace(str(tmp_path), device="cpu"):
        with profiling.span("test.block"):
            torch.arange(16.0).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    got = json.loads((tmp_path / "spans.json").read_text())
    assert [e[0] for e in got["spans"]] == ["test.block"]
    assert got["summary"]["test.block"]["count"] == 1
    assert got["counters"] == {}
