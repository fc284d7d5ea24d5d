"""The one traffic generator: it builds a cell's calls from the seed
through the entry its traffic mix names, runs the closed loop of those
calls for the window, and in a traced run wraps the program's modules to
read what the per-layer metrics need.

A traffic mix (traffic/<name>.json) names an entry of the program and
its sizes. The entry is a file entries/<entry>.py (harness.entry) with

  KIND              "offline" (calls of whole images or clouds, counted
                    in samples) or "frames" (the viewer's frames)
  Traffic(mix, config, scene, seed, device, ranks)
                    the cell's state; .call(i) makes call i of the
                    window (None: a call outside the window's samples)
                    and returns the record the check reads; .final()
                    what the check reads after the window
  numbers(run, settings, want, got)
                    {number: value} of the check, want the reference's
                    answers (check.Reference), got the control's or None
                    for the run's own
  control_run(run, calls, frames)
                    fills run as a window of that many calls would, for
                    the control

ranks is (rank, world) of the cell's process group, or None on one card.
Every call ends in a host read of its answer, which the run keeps for
the check. The program is reached through its API, engine.integrator's
render_pooled (which the API calls, wrapped in a traced run to read its
iteration count) and ops.intersect's two queries (wrapped in one traced
call to copy the rays they are handed).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

MASK = 0xFFFFFFFF
WARMUP_NONCE = 0x80000000   # samples no window call draws
TAP_STRIDE = 16             # every 16th lane of a query is copied


@dataclass
class Run:
    """What one run measured and produced."""
    entry: str
    kind: str                 # the entry's KIND
    width: int
    height: int
    spp: int
    samples_per_call: int
    setup_s: float = 0.0
    window_start: float = 0.0
    calls: list = field(default_factory=list)    # dicts, in call order
    iters: list = field(default_factory=list)    # render_pooled's, traced
    trace: dict = field(default_factory=dict)    # run.traced's readings
    final: dict = field(default_factory=dict)    # the entry's final()
    peak: int = 0             # peak device bytes on the fullest card
    card: str = ""


def start(mix: dict, config: dict, scene, seed: int, device, ranks=None,
          base=None):
    """(the entry's Traffic for the mix, an empty Run)."""
    from portbench import harness
    mod = harness.entry(mix["entry"], base or harness.HERE)
    w, h, spp = int(mix["width"]), int(mix["height"]), int(mix["spp"])
    traffic = mod.Traffic(mix, config, scene, seed, device, ranks)
    return traffic, Run(mix["entry"], mod.KIND, w, h, spp, w * h * spp)


def window(traffic, run: Run, seconds: float, sync, stop=None):
    """The closed loop: calls back to back until `seconds` have passed
    since the first began; every call is kept. stop(flag) -> flag, where
    given, makes the ranks of a group agree after each call."""
    run.window_start = t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        rec = traffic.call(i)
        sync()
        t1 = time.perf_counter()
        rec.update(t0=t0, t1=t1)
        run.calls.append(rec)
        i += 1
        done = t1 - t_start >= seconds
        if stop is not None:
            done = stop(done)
        if done:
            break


class Wrap:
    """Within the block, module.name calls `hook(result, *args)` after
    each call and returns the result unchanged."""

    def __init__(self, module, name, hook):
        self.module, self.name, self.hook = module, name, hook

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)
        hook = self.hook

        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            hook(out, *args, **kwargs)
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def count_iters(run: Run):
    """Wrap render_pooled so that each call's iteration count lands in
    run.iters."""
    from tracer_tpu_torch.engine import integrator
    return Wrap(integrator, "render_pooled",
                lambda out, *a, **k: run.iters.append(int(out["iters"])))


def tap_queries(taps: list):
    """Wrap the two queries: each call appends a dict with its strided
    rays, tmax and answer (every TAP_STRIDE-th lane) and its lane
    count."""
    import torch
    from tracer_tpu_torch.ops import intersect

    def rays(origin, d, tmax):
        n = d.shape[1]
        o = origin.expand(3, n)[:, ::TAP_STRIDE]
        tm = torch.as_tensor(tmax, dtype=torch.float32,
                             device=d.device).expand(n)
        return n, o.clone(), d[:, ::TAP_STRIDE].clone(), \
            tm[::TAP_STRIDE].clone(), int((tm > 0).sum())

    def closest(out, dense, tmax, origin, d, **kw):
        n, o, dd, tm, live = rays(origin, d, tmax)
        taps.append({"query": "closest", "n": n, "live": live, "o": o,
                     "d": dd, "tmax": tm, "t": out[1][::TAP_STRIDE].clone()})

    def any_(out, dense, tmax, origin, d, **kw):
        n, o, dd, tm, live = rays(origin, d, tmax)
        taps.append({"query": "any", "n": n, "live": live, "o": o, "d": dd,
                     "tmax": tm, "hit": out[::TAP_STRIDE].clone()})

    return (Wrap(intersect, "closest_hit", closest),
            Wrap(intersect, "any_hit", any_))
