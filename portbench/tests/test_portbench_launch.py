"""The process group of a cell on several ranks (launch.py): rank 0 takes
its own group down before it waits for any rank, since NCCL's teardown
waits for every rank of the group; after a failure it ends the ranks
first and then aborts its group; a destroy that outlives JOIN_S ends
the ranks and the process; a rank that raises ends the run with an
error, not a hang; and a rank that loads a module of JAX or the JAX
package leaves the run without a result."""

import json
import os
import threading
import time

import pytest

from portbench import harness, launch
from portbench import run as bench_run

FAILING_ENTRY = """
import torch
import torch.distributed as dist

KIND = "offline"


class Traffic:
    def __init__(self, mix, config, scene, seed, device, ranks):
        if ranks[0] == 1:
            raise RuntimeError("rank 1 fails in its set-up")

    def call(self, i):
        t = torch.zeros(1)
        dist.all_reduce(t)      # waits for rank 1, which is gone
        return {"nonce": 0, "out": t.numpy()}

    def final(self):
        return {}


def numbers(run, settings, want, got=None):
    return {}


def control_run(run, calls, frames):
    run.calls = []
"""

FORBIDDEN_ENTRY = """
import sys
import types

import torch
import torch.distributed as dist

KIND = "offline"


class Traffic:
    def __init__(self, mix, config, scene, seed, device, ranks):
        self.device = device
        if {plant} and ranks[0] == 1:
            sys.modules["flax"] = types.ModuleType("flax")

    def call(self, i):
        t = torch.ones(1, device=self.device)
        dist.all_reduce(t)
        return {{"nonce": 0, "out": t.cpu().numpy()}}

    def final(self):
        return {{}}


def numbers(run, settings, want, got=None):
    return {{}}


def control_run(run, calls, frames):
    run.calls = []
"""

FAIL_WITHIN_S = 60


class FakeRank:
    def __init__(self, r, log, alive=True, exitcode=0):
        self.r, self.log, self.alive, self.exitcode = r, log, alive, exitcode

    def is_alive(self):
        return self.alive

    def join(self, timeout=None):
        self.log.append(f"join {self.r}")

    def terminate(self):
        self.log.append(f"terminate {self.r}")
        self.alive, self.exitcode = False, -15

    def kill(self):
        self.log.append(f"kill {self.r}")
        self.alive, self.exitcode = False, -9


def fake_group(monkeypatch, backend, alive):
    """A Group of three ranks whose ranks 1 and 2 are FakeRanks, over a
    torch.distributed whose teardown calls are recorded."""
    import torch.distributed as dist
    log = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: backend)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: log.append("destroy"))
    monkeypatch.setattr(dist.distributed_c10d, "_abort_process_group",
                        lambda *a: log.append("abort"))
    group = launch.Group(3, "cuda", ())
    group.procs = [FakeRank(r, log, alive) for r in (1, 2)]
    return group, log


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_a_clean_exit_destroys_the_group_before_it_joins_a_rank(
        monkeypatch, backend):
    group, log = fake_group(monkeypatch, backend, alive=False)
    assert group.__exit__(None, None, None) is False
    assert log[0] == "destroy" and "abort" not in log
    assert log[1:3] == ["join 1", "join 2"]


def test_a_clean_exit_ends_a_rank_that_outlives_the_joins(monkeypatch):
    group, log = fake_group(monkeypatch, "nccl", alive=True)
    with pytest.raises(RuntimeError, match="exit codes"):
        group.__exit__(None, None, None)
    assert log[:3] == ["destroy", "join 1", "join 2"]
    assert "terminate 1" in log and "terminate 2" in log


@pytest.mark.parametrize("backend,down", [("nccl", "abort"),
                                          ("gloo", "destroy")])
def test_a_failed_exit_ends_the_ranks_before_it_takes_the_group_down(
        monkeypatch, backend, down):
    group, log = fake_group(monkeypatch, backend, alive=True)
    assert group.__exit__(RuntimeError, RuntimeError("x"), None) is False
    assert log[-1] == down and log.count(down) == 1
    assert {"terminate 1", "terminate 2"} <= set(log[:-1])
    assert not any(p.is_alive() for p in group.procs)


def test_a_destroy_that_outlives_join_s_ends_ranks_and_process(
        monkeypatch):
    """Rank 0's destroy waits on a rank that never destroys its group:
    after JOIN_S the ranks are ended, then rank 0 exits with EXIT_HUNG."""
    import torch.distributed as dist
    group, log = fake_group(monkeypatch, "nccl", alive=True)
    exited = threading.Event()
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: log.append("destroy") or exited.wait(30))
    monkeypatch.setattr(launch, "JOIN_S", 0.2)
    monkeypatch.setattr(os, "_exit", lambda code: (
        log.append(f"exit {code}"), exited.set()))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exit codes"):
        group.__exit__(None, None, None)
    assert time.monotonic() - t0 < 10
    assert log.index("terminate 1") < log.index(f"exit {launch.EXIT_HUNG}")
    assert log.index("terminate 2") < log.index(f"exit {launch.EXIT_HUNG}")


def plant_cell(base, name, entry, chips=2):
    """A cell `cornell-box.<name>` of `chips` ranks in the copy of the
    benchmark at base, whose traffic runs the entry's source `entry`."""
    (base / "entries" / f"{name.replace('-', '_')}.py").write_text(entry)
    (base / "traffic" / f"{name}.json").write_text(json.dumps(
        {"entry": name.replace("-", "_"), "width": 4, "height": 2,
         "spp": 1, "sensor_config": 0, "warmup_calls": 1}))
    (base / "workloads" / f"cornell-box.{name}.json").write_text(
        json.dumps({"calls": 1, "pixels": 1, "limits": {}}))
    bench = harness.manifest(base.parent)
    bench["workloads"].append({"name": f"cornell-box.{name}",
                               "config": "cornell-box", "traffic": name,
                               "chips": chips, "why": name})
    (base.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.Cell(harness.manifest(base.parent), f"cornell-box.{name}",
                        base)


def watch_ranks(mp):
    """The processes Group starts, as a list filled on its entry."""
    started = []
    real_enter = launch.Group.__enter__

    def enter(self):
        dev = real_enter(self)
        started.extend(self.procs)
        return dev

    mp.setattr(launch.Group, "__enter__", enter)
    return started


def test_a_rank_that_raises_ends_the_run_with_an_error(bench_copy):
    """Two gloo ranks on the CPU; rank 1 raises in drive_cell while rank
    0 waits for it in a collective. The run raises within
    FAIL_WITHIN_S and leaves no rank behind."""
    cell = plant_cell(bench_copy, "fails-on-rank1", FAILING_ENTRY)
    t0 = time.monotonic()
    with pytest.MonkeyPatch.context() as mp:
        started = watch_ranks(mp)
        with pytest.raises(Exception):
            bench_run.run_cell(cell, 5, 1.0, False, "cpu", time.perf_counter())
    assert time.monotonic() - t0 < FAIL_WITHIN_S
    assert len(started) == 1 and not started[0].is_alive()
    assert started[0].exitcode != 0


@pytest.mark.parametrize("plant", [False, True], ids=["none", "flax"])
def test_a_rank_that_loads_a_forbidden_module_gives_no_result(
        bench_copy, plant):
    """Two gloo ranks; rank 1's entry puts a stand-in module named
    flax in its sys.modules. Without it the run gives its result; with
    it, rank 0 raises once the window has closed and no rank is left."""
    cell = plant_cell(bench_copy, "loads-flax-on-rank1",
                      FORBIDDEN_ENTRY.format(plant=plant))
    with pytest.MonkeyPatch.context() as mp:
        started = watch_ranks(mp)
        if plant:
            with pytest.raises(RuntimeError, match="JAX"):
                bench_run.run_cell(cell, 5, 0.5, False, "cpu",
                                   time.perf_counter())
        else:
            r = bench_run.run_cell(cell, 5, 0.5, False, "cpu",
                                   time.perf_counter())
            assert r["correct"] and r["device"]["count"] == 2
    assert len(started) == 1 and not started[0].is_alive()
    assert "flax" not in bench_run.forbidden_modules()
