"""A run of each cell's kind on the CPU at a small size, past the look
for a card: sound, it reads correct; with the timed path broken
underneath, it reads not correct, once for each fault the cell can
have (a step that returns its state unchanged, half of the samples left
out, an answer altered where it is produced, the last rows of
the answers altered). The cells run on one
card, so no exchange between cards can be left out."""

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
