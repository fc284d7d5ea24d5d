"""Profiling / tracing (port of tracer_tpu/utils/profiling.py):
accumulating phase timers and a torch.profiler trace.

On a CUDA device a phase is timed by a pair of CUDA events on the
current stream, so it covers what the device executed, not the
asynchronous dispatch; on the CPU by the host's clock. The JAX package's
compiled_stats reads XLA's cost analysis of a compiled program; eager
PyTorch has no such program, so it has no counterpart here.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


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
    chrome://tracing)."""
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
