"""A run of each cell's kind on the CPU at a small size, past the look
for a card: sound, it reads correct; with the timed path broken
underneath, it reads not correct, once for each fault the cell can
have (a step that returns its state unchanged, half of the samples left
out, an answer altered where it is produced, the last rows of
the answers altered). The four-card capture runs on four gloo ranks, the
fault planted in every rank, and can have one more: the exchange between
the ranks left out."""

import dataclasses
import time

import pytest
import torch

from portbench import harness
from portbench import run as bench_run
from tracer_tpu_torch.engine import api, integrator

BENCH = harness.manifest()
KINDS = {"render": "cornell-box.render-256spp",
         "capture": "cornell-box.capture-100spp",
         "viewer": "cornell-box.viewer-800x600"}
MESH = "cornell-box.capture-100spp.mesh4"

# The mesh cell's entry in a copy of the benchmark: ranks 1-3 plant the
# fault in their own process before they build the state (rank 0 is the
# test's process, where the test's monkeypatch plants it), then run the
# sound entry.
PLANTED = """
import importlib.util
from pathlib import Path

import pytest

from portbench import harness

_sound = harness.entry("sample_points_sharded_sound",
                       Path(__file__).resolve().parents[1])
KIND, numbers, control_run = _sound.KIND, _sound.numbers, _sound.control_run


class Traffic(_sound.Traffic):
    def __init__(self, mix, config, scene, seed, device, ranks):
        if ranks[0] != 0:
            spec = importlib.util.spec_from_file_location(
                "planted_faults", {faults!r})
            faults = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(faults)
            getattr(faults, {fault!r})(pytest.MonkeyPatch())
        super().__init__(mix, config, scene, seed, device, ranks)
"""


def small(cell):
    mix = dict(cell.traffic, width=12, height=8,
               spp=min(int(cell.traffic["spp"]), 3))
    return mix, dict(cell.check, pixels=24)


def run_small(kind, seconds=0.0):
    cell = harness.Cell(BENCH, KINDS[kind])
    mix, settings = small(cell)
    return bench_run.run_cell(cell, 3_141_592_653, seconds, False, "cpu",
                              time.perf_counter(), "cpu", mix, settings)


def unchanged(monkeypatch):
    """The pool's step leaves its state as it was: nothing rendered."""
    real = integrator.render_pooled

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        out["img"] = torch.zeros_like(out["img"])
        if "points" in out:
            pos, dist, inten = out["points"]
            out["points"] = (torch.full_like(pos, -1.0),
                             torch.full_like(dist, float("inf")),
                             torch.zeros_like(inten))
        return out
    monkeypatch.setattr(integrator, "render_pooled", broken)
    monkeypatch.setattr(api, "step", lambda s: s)


def half(monkeypatch):
    """Half of the samples rendered, the mean taken over those."""
    real = integrator.render_pooled

    def broken(seed, nonce, scene, cam, ambience, w, h, kind, spp, mode,
               **kwargs):
        return real(seed, nonce, scene, cam, ambience, w, h, kind,
                    max(1, spp // 2), mode, **kwargs)
    monkeypatch.setattr(integrator, "render_pooled", broken)
    real_step = api.step

    def step(s):   # the viewer: every other frame's sample is dropped
        return (dataclasses.replace(s, nonce=(s.nonce + 1) & 0xFFFFFFFF)
                if s.nonce % 2 else real_step(s))
    monkeypatch.setattr(api, "step", step)


def altered(monkeypatch):
    """Every answer off by a thousandth where it is produced."""
    real = integrator.render_pooled

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        out["img"] = out["img"] * 1.001
        if "points" in out:
            pos, dist, inten = out["points"]
            out["points"] = (pos, dist, inten * 1.001)
        return out
    monkeypatch.setattr(integrator, "render_pooled", broken)


def tail(monkeypatch):
    """The last rows of each answer (the pool's last work items) off by
    1%: a fault confined to a few answers, which a 90th percentile
    alone would pass."""
    real = integrator.render_pooled

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        img = out["img"].clone()
        img[-max(1, img.shape[0] // 12):] *= 1.01     # (h, w, 3)
        out["img"] = img
        if "points" in out:
            pos, dist, inten = out["points"]
            inten = inten.clone()
            inten[-max(1, inten.shape[-1] // 12):] *= 1.01
            out["points"] = (pos, dist, inten)
        return out
    monkeypatch.setattr(integrator, "render_pooled", broken)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sound_run_is_correct(kind):
    r = run_small(kind)
    assert r["correct"], r["checks"]
    assert r["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", [unchanged, half, altered, tail],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fault_is_not_correct(kind, fault, monkeypatch):
    fault(monkeypatch)
    r = run_small(kind)
    assert not r["correct"], (kind, fault.__name__, r["checks"])


def exchange(monkeypatch):
    """The exchange between ranks left out: each collective of
    parallel/render.py leaves its tensor as this rank holds it."""
    from tracer_tpu_torch.parallel import render as par
    monkeypatch.setattr(par, "_all_reduce", lambda *a, **k: None)


def run_mesh(base, fault):
    """The four-card capture on four gloo ranks at 12x8, 4 spp, through
    the copy of the benchmark at base, whose entry plants the fault in
    ranks 1-3 (its sound run is test_portbench_mesh4's)."""
    entries = base / "entries"
    (entries / "sample_points_sharded.py").rename(
        entries / "sample_points_sharded_sound.py")
    (entries / "sample_points_sharded.py").write_text(PLANTED.format(
        faults=__file__, fault=fault.__name__))
    cell = harness.Cell(BENCH, MESH, base)
    mix = dict(cell.traffic, width=12, height=8, spp=4)
    return bench_run.run_cell(cell, 3_141_592_653, 0.0, False, "cpu",
                              time.perf_counter(), "cpu", mix,
                              dict(cell.check, pixels=24))


@pytest.mark.parametrize("fault", [unchanged, half, altered, tail, exchange],
                         ids=lambda f: f.__name__)
def test_mesh_fault_is_not_correct(bench_copy, fault, monkeypatch):
    fault(monkeypatch)
    r = run_mesh(bench_copy, fault)
    assert not r["correct"], (fault.__name__, r["checks"])
