"""Profiling / tracing (port of tracer_tpu/utils/profiling.py):
accumulating phase timers, a torch.profiler trace, and the recorder of
named spans and counters that the program places at its layer
boundaries.

On a CUDA device a phase is timed by a pair of CUDA events on the
current stream, so it covers what the device executed, not the
asynchronous dispatch; on the CPU by the host's clock. The JAX package's
compiled_stats reads XLA's cost analysis of a compiled program; eager
PyTorch has no such program, so it has no counterpart here.

The recorder is on while a torch.profiler session records or inside
tracing(); off, span() returns one shared no-op object and count()
returns at once (a flag read; nothing allocated, nothing on the card).
While torch.export or torch.compile traces the program, or a CUDA graph
is being captured, it is off whatever the flags say: no span or count
is captured into a program that would replay it unseen.

  span(name)         a host span: under the profiler a host op of that
                     name on the trace's own clock (_RecordFunctionFast:
                     a cpu_op with no device mirror, unlike
                     record_function's user annotations), and an entry
                     (name, start_ns, end_ns, parent) on the host's
                     perf_counter_ns in a bounded in-memory list
  host_read(site)    span host.read.<site> and counters host.reads and
                     host.reads.<site>: one explicit device-to-host read
  count(name, n)     a counter
  summary()          per span name: count, total and self seconds (self:
                     total less the part its child spans cover)
  counters(), spans(), reset(), write(path)
  tracing()          the recorder on for a block, without a profiler

It keeps one stack of open spans: record from one thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler


class PhaseTimer:
    """Accumulating timer keyed by phase name, for one device."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block: seconds between two CUDA events on a card
        (the block's end is waited for), host seconds on the CPU."""
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
        else:
            t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                end.record(torch.cuda.current_stream(self.device))
                end.synchronize()
                dt = start.elapsed_time(end) * 1e-3
            else:
                dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"{name:30s} {total * 1000:10.2f} ms "
                 f"({self.counts[name]} calls, "
                 f"{total * 1000 / max(self.counts[name], 1):8.2f} ms/call)"
                 for name, total in rows]
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps({k: {"total_s": v, "calls": self.counts[k]}
                           for k, v in self.totals.items()})


@contextlib.contextmanager
def device_trace(log_dir: str | None = None, device="cuda"):
    """Capture a torch.profiler trace of the block and yield the profiler
    (its key_averages() and events() are complete once the block has
    ended). On a CUDA device the card's kernels are traced beside the
    host's ops (tracing the card alone was tried on an H100 and lost the
    first of a render's kernels in one run of two). With log_dir, a
    Chrome trace is written there (view it in Perfetto or
    chrome://tracing), and the recorder's spans.json beside it (write);
    the recorder is on while the profiler records."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        write(os.path.join(log_dir, "spans.json"))


# ---------------------------------------------------------------------------
# The recorder

# spans kept in the timeline; later ones are counted in "spans.dropped"
# (summary() counts every span whatever the bound)
SPAN_LIMIT = 1 << 18

_depth = 0          # open tracing() blocks
_spans: list = []   # [name, start_ns, end_ns, parent index or -1], start order
_open: list = []    # open spans: [name, start_ns, child ns, index or -1]
_totals: dict = {}  # name -> [count, total ns, self ns]
_counts: dict = {}


def active() -> bool:
    """True while the recorder records: a torch.profiler session records
    or a tracing() block is open, and no program is being traced or
    captured."""
    if not (_depth or _autograd_profiler._is_profiler_enabled):
        return False
    return not (torch.compiler.is_compiling()
                or (torch.cuda.is_initialized()
                    and torch.cuda.is_current_stream_capturing()))


@contextlib.contextmanager
def tracing():
    """The recorder on for the block (nestable), with or without a
    profiler."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


# what span() and host_read() return while off: one object, which
# torch.export's tracer of a while_loop body also accepts
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "fast", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.fast = None
        if _autograd_profiler._is_profiler_enabled:
            self.fast = torch._C._profiler._RecordFunctionFast(self.name)
            self.fast.__enter__()
        index = -1
        if len(_spans) < SPAN_LIMIT:
            index = len(_spans)
            _spans.append(None)
        else:
            _counts["spans.dropped"] = _counts.get("spans.dropped", 0) + 1
        self.entry = [self.name, time.perf_counter_ns(), 0, index]
        _open.append(self.entry)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.fast is not None:
            self.fast.__exit__(*exc)
        name, start, child, index = _open.pop()
        dur = end - start
        tot = _totals.setdefault(name, [0, 0, 0])
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - child
        if _open:
            _open[-1][2] += dur
        if index >= 0:
            parent = _open[-1][3] if _open else -1
            _spans[index] = [name, start, end, parent]
        return False


def span(name: str):
    """A context manager that records the block as span `name` while the
    recorder is on, and does nothing otherwise."""
    return _Span(name) if active() else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while the recorder is on."""
    if active():
        _counts[name] = _counts.get(name, 0) + n


def host_read(site: str):
    """Span host.read.<site> around one explicit device-to-host read, and
    one more in counters host.reads and host.reads.<site>."""
    if not active():
        return _NO_SPAN
    _counts["host.reads"] = _counts.get("host.reads", 0) + 1
    key = "host.reads." + site
    _counts[key] = _counts.get(key, 0) + 1
    return _Span("host.read." + site)


def summary() -> dict:
    """{span name: {"count", "total_s", "self_s"}} of every span
    recorded since the last reset()."""
    return {k: {"count": c, "total_s": t * 1e-9, "self_s": own * 1e-9}
            for k, (c, t, own) in _totals.items()}


def counters() -> dict:
    """{counter: value} since the last reset()."""
    return dict(_counts)


def spans() -> list:
    """The recorded spans in start order: [name, start_ns, end_ns,
    parent index or -1] on time.perf_counter_ns (spans still open left
    out)."""
    return [e for e in _spans if e is not None]


def reset() -> None:
    """Forget every span and counter (spans open now are still summed
    when they end, but not kept in the list)."""
    _spans.clear()
    _totals.clear()
    _counts.clear()
    for e in _open:
        e[3] = -1


def write(path: str) -> None:
    """The recorder's spans, summary and counters as JSON."""
    with open(path, "w") as f:
        json.dump({"spans": spans(), "summary": summary(),
                   "counters": counters()}, f)
