"""The span-and-counter recorder of tracer_tpu_torch/utils/profiling.py
and its places in the program: off it records nothing and changes no
bit; spans nest with the right self times and reach torch.profiler as
host ops; the pool's counters and host reads agree with render_pooled's
own outputs; an export records nothing; the sorted queries' span, the
kernels' lane counters and the collectives' span and bytes; the
benchmark's reader of the sorted queries' host time."""

import dataclasses
import json
import os
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.profiler import ProfilerActivity, profile

import tracer_tpu_torch as T
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.ops import intersect
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.parallel import render as par
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
    api.step's bits, with one host read of its counters; its queries'
    ops count the lanes they are handed, as api.step's do."""
    s = T.step(dataclasses.replace(_state(0, h=10, w=12), mode=True))
    with profiling.tracing():
        blob = aot.export_step(s)
    assert profiling.summary() == {} and profiling.counters() == {}
    step = aot.load(blob)
    with profiling.tracing():
        got = step(s)
    c = profiling.counters()
    lanes = {k: v for k, v in c.items() if k.startswith("query.lanes.")}
    assert {k: v for k, v in c.items() if k not in lanes} == {
        "host.reads": 1, "host.reads.aot.counters": 1}
    profiling.reset()
    with profiling.tracing():
        want = T.step(s)
    assert lanes and lanes == {k: v for k, v in profiling.counters().items()
                               if k.startswith("query.lanes.")}
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


def _rays(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    origin = torch.tensor([[0.0], [0.8], [1.8]]).expand(3, n)
    d = torch.randn((3, n), generator=g)
    d = d / torch.linalg.vector_norm(d, dim=0)
    tmax = torch.rand((n,), generator=g) * 4.0
    tmax[::5] = 0.0                                   # dead lanes
    return origin, d, tmax


@pytest.mark.parametrize("perm", ["odmorton", "oct", "off"])
def test_query_sort_span_once_per_sorted_query(perm):
    """query.sort wraps each query that sorts its lanes (a key named, or
    "auto" on a card) once, and nothing when the recorder is off or the
    query does not sort; the answers are the unsorted query's."""
    dense = intersect.build_dense(torch.as_tensor(
        testscenes.cornell_like()[0]))
    origin, d, tmax = _rays(300)
    want_c = intersect.closest_hit(dense, tmax, origin, d, perm="off")
    want_a = intersect.any_hit(dense, tmax, origin, d, perm="off")
    intersect.closest_hit(dense, tmax, origin, d, perm=perm)
    assert profiling.summary() == {} and profiling.counters() == {}
    with profiling.tracing():
        got_c = intersect.closest_hit(dense, tmax, origin, d, perm=perm)
        got_a = intersect.any_hit(dense, tmax, origin, d, perm=perm)
        intersect.closest_hit(dense, tmax, origin, d)     # auto: CPU, no sort
    for a, b in zip(got_c, want_c):
        assert torch.equal(a, b)
    assert torch.equal(got_a, want_a)
    sorts = profiling.summary().get("query.sort", {}).get("count", 0)
    assert sorts == (0 if perm == "off" else 2)


@pytest.mark.parametrize("perm", ["odmorton", "dmorton"])
def test_prep_counters_and_spans_of_the_sorted_queries(perm):
    """query.prep.plain counts the lanes of each sorted query whose
    preparation the plain version did (every one on the CPU), and
    query.prep.kernel none; query.sort wraps each sorted query once, an
    unsorted one not; query.schedule wraps each schedule walk_operands
    builds (inside a query on the card only: on the CPU the ops' plain
    version builds none)."""
    tris, tm = testscenes.subdivide(*testscenes.cornell_like()[:2],
                                    levels=2)
    dense = intersect.build_dense(torch.as_tensor(tris))
    assert dense.chunk_bounds.shape[0] > 1
    origin, d, tmax = _rays(300)
    with profiling.tracing():
        intersect.closest_hit(dense, tmax, origin, d, perm=perm)
        intersect.any_hit(dense, tmax, origin, d, perm=perm)
        intersect.closest_hit(dense, tmax, origin, d, perm="off")
        summ, c = profiling.summary(), profiling.counters()
        assert c["query.prep.plain"] == 600
        assert "query.prep.kernel" not in c
        assert summ["query.sort"]["count"] == 2
        assert "query.schedule" not in summ
        ik.walk_operands("closest_hit", intersect.ray_features_t(origin, d),
                         tmax, dense.chunk_bounds)
    assert profiling.summary()["query.schedule"]["count"] == 1


def test_prep_counter_over_a_pooled_render(monkeypatch):
    """With every query sorted (resolve_perm forced to odmorton, as "auto"
    does on a card), query.prep.plain over a pooled render equals the
    lanes the queries hand the kernel wrappers (query.lanes.*), and the
    render's bits are those of the unsorted render's (the box's one chunk
    has no cross-chunk tie)."""
    s = _state(0)
    want = _pooled(s, 3)
    monkeypatch.setattr(intersect, "resolve_perm",
                        lambda *a, **k: "odmorton")
    with profiling.tracing():
        got = _pooled(s, 3)
    c = profiling.counters()
    lanes = sum(v for k, v in c.items() if k.startswith("query.lanes."))
    assert c["query.prep.plain"] == lanes > 0
    assert "query.prep.kernel" not in c
    assert profiling.summary()["query.sort"]["count"] == 2 * got["iters"]
    for k in ("img", "rays_traced", "iters"):
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k]))


@pytest.mark.parametrize("streamed", [False, True])
def test_query_lanes_count_the_lanes_handed_to_the_kernels(streamed,
                                                          monkeypatch):
    """query.lanes.<variant> sums, over a pooled render, the lanes each
    query hands the kernel wrapper, under the variant's name (on the CPU
    its plain version; the streamed variants where the scene streams)."""
    if streamed:
        monkeypatch.setattr(ik, "STREAM_MIN_T_PAD", 0)
    handed = {"closest": 0, "any": 0}
    for q in handed:
        orig = getattr(ik, f"{q}_hit")

        def wrapped(coeffs, phi, *a, _q=q, _orig=orig, **k):
            handed[_q] += phi.shape[1]
            return _orig(coeffs, phi, *a, **k)
        monkeypatch.setattr(ik, f"{q}_hit", wrapped)
    s = _state(0)
    with profiling.tracing():
        _pooled(s, 3)
    c = profiling.counters()
    lanes = {k[len("query.lanes."):]: v for k, v in c.items()
             if k.startswith("query.lanes.")}
    suffix = "_streamed" if streamed else ""
    assert lanes == {"closest_hit" + suffix: handed["closest"],
                     "any_hit" + suffix: handed["any"]}
    assert handed["closest"] == c["pool.lane_iters"]


@pytest.mark.parametrize("accel", ["dense", "lbvh"])
def test_interaction_lanes_count_each_launch(accel, monkeypatch):
    """interaction.lanes: each launch of K16 adds its lanes, so that over
    a pooled render it is the pool's lane-iterations (pool.lane_iters),
    as on the card. Here the op's CUDA implementation runs on the CPU
    with a stand-in launch that writes the plain version's answer into
    the outputs it is handed; the render is the plain one's bit for
    bit."""
    from tracer_tpu_torch.engine import interaction
    from tracer_tpu_torch.ops import cuda_lib
    s = _state(0, accel=accel)
    want = _pooled(s, 3)

    def launch(name, device, ptrs, ints):
        (tris, perm, tri_mat, mat_rows, tmax, wl, o, d, best_t, best_i,
         leaf), outs = ptrs[:11], ptrs[11:]
        assert name == "interaction" and ints[0] == d.shape[1]
        for out, x in zip(outs, interaction._plain(
                tris, perm, tri_mat, mat_rows, tmax, o, d, wl, best_t,
                best_i, leaf)):
            out.copy_(x)

    monkeypatch.setattr(cuda_lib, "launch", launch)
    for name, args_fn in (("dense", interaction.dense_args),
                          ("lbvh", interaction.lbvh_args)):
        monkeypatch.setattr(interaction, name, lambda *a, _f=args_fn:
                            interaction._interaction_cuda(*_f(*a)))
    with profiling.tracing():
        got = _pooled(s, 3)
    c = profiling.counters()
    assert c["interaction.lanes"] == c["pool.lane_iters"] > 0
    for k in ("img", "rays_traced", "iters"):
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k]))


def _mesh_rank(rank, world, store, out):
    """One gloo rank: the sharded calls under the recorder, each call's
    spans and counters apart; rank 0 writes them to `out`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        s = _state(2, h=6, w=8)
        meshes = {"sample": par.make_mesh(1, world),
                  "tile": par.make_mesh(world, 1)}
        calls = {"points": lambda: par.sample_points_sharded(
                     s, meshes["sample"], 2),
                 "render": lambda: par.render_pooled_sharded(
                     _state(0, h=6, w=8), meshes["tile"], 2),
                 "step": lambda: par.step_sharded(_state(0, h=6, w=8),
                                                  meshes["tile"])}
        got = {}
        for name, call in calls.items():
            profiling.reset()
            with profiling.tracing():
                call()
            got[name] = {"count": profiling.summary()["mesh.reduce"]["count"],
                         "bytes": profiling.counters()["mesh.reduce_bytes"]}
        profiling.reset()
        calls["points"]()
        got["off"] = (profiling.summary(), profiling.counters())
        if rank == 0:
            with open(out, "w") as f:
                json.dump(got, f)
    finally:
        dist.destroy_process_group()


def test_mesh_reduce_once_per_collective(tmp_path):
    """With 2 gloo ranks: the capture over the sample axis makes the
    merge's MIN, MAX and SUM and the assembly's SUM, a render or step
    over the tile axis the assembly's SUM alone; mesh.reduce counts each
    once and mesh.reduce_bytes their tensors' bytes exactly."""
    out = tmp_path / "got.json"
    mp.spawn(_mesh_rank, nprocs=2, join=True,
             args=(2, str(tmp_path / "store"), str(out)))
    got = json.loads(out.read_text())
    n = 6 * 8
    assert got["points"] == {"count": 4,
                             "bytes": 4 * n + 4 * n + 4 * 4 * n + 4 * 4 * n}
    assert got["render"] == got["step"] == {"count": 1, "bytes": 4 * 3 * n}
    assert got["off"] == [{}, {}]


def test_query_prep_reader_reads_nothing_untraced():
    from portbench import drive, harness
    read = harness.reader("query.prep_ms_per_iter.streamed")
    run = drive.Run("sample_n_frames", "offline", 4, 2, 3, 24)
    assert read(run) is None
    run.calls = [{"t0": 0.0, "t1": 1.0}]
    run.iters = [5]
    assert read(run) is None


def test_query_prep_reader_reads_the_sorted_queries(monkeypatch):
    """A traced stretch whose queries sort (every key forced to
    odmorton, as "auto" does on a card): the reader gives the self ms of
    query.sort and the ms of query.schedule over the pool's iterations."""
    from portbench import drive, harness
    monkeypatch.setattr(intersect, "resolve_perm",
                        lambda *a, **k: "odmorton")
    s = _state(0)
    iters = []
    with drive.Wrap(tint, "render_pooled",
                    lambda out, *a, **k: iters.append(out["iters"])):
        with profiling.tracing():
            T.sample_n_frames(s, 3)
    summ = profiling.summary()
    assert summ["query.sort"]["count"] == 2 * iters[0]
    run = drive.Run("sample_n_frames", "offline", W, H, 2, W * H * 2)
    run.trace = {"iters": iters[0]}
    want = 1e3 * (summ["query.sort"]["self_s"]
                  + summ.get("query.schedule", {}).get("total_s", 0.0)) \
        / iters[0]
    got = harness.reader("query.prep_ms_per_iter.streamed")(run)
    assert got == pytest.approx(want) and got > 0
