"""The benchmark of tracer_tpu_torch on the CUDA cards a cell asks for.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

builds the cell's scene and engine state from the seed, warms up the
cell's own shapes, runs the cell's calls back to back for --seconds,
checks sampled answers against the plain reference, and prints one JSON
line: with --trace 0 the cell's end-to-end metrics, with --trace 1 its
per-layer metrics (a profiled call, and one with the rays tapped, after
the window) and the breakdown. A cell on n > 1 cards runs as n ranks,
one process per card (launch.py); this process is rank 0. Without a
CUDA card, or with fewer than the cell asks for, it prints no result and
exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}
FORBIDDEN = ("jax", "jaxlib", "flax", "tracer_tpu")
TRACED_FRAMES = 8


def set_caches(root: Path = ROOT) -> None:
    """Every compiler cache at a fixed directory of the checkout."""
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "build" / "portbench" / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def traced(traffic, run, scene, sync, ranks=None):
    """The traced run's calls after the window: a profiled stretch (one
    call; eight frames of the viewer) and, offline, one call of the same
    work with the rays of its queries tapped. Every rank makes them, from
    a barrier under the profiler; the busy time and the collectives'
    device time are the ranks' means."""
    from portbench import drive, trace
    from portbench.yardstick import roofline
    n = len(run.iters)
    frames = TRACED_FRAMES if run.kind == "frames" else 1

    def stretch():
        for _ in range(frames):
            traffic.call(None)

    align = None if ranks is None else (lambda: all_reduce(0.0, "max"))
    with drive.count_iters(run):
        prof, wall = trace.profiled(stretch, sync, align)
    run.trace = trace.reduce(prof, wall)
    run.trace["iters"] = sum(run.iters[n:])
    del run.iters[n:], prof
    if ranks is not None:
        for k in ("busy_s", "collective_s"):
            run.trace[k] = all_reduce(run.trace[k], "sum") / ranks[1]
    peaks = roofline.peaks(run.card)
    if run.kind == "frames" or peaks is None:
        return
    taps = []
    closest, any_ = drive.tap_queries(taps)
    with closest, any_:
        traffic.call(None)
    sync()
    run.trace["bound_s"] = roofline.bound_s(taps, scene[0], drive.TAP_STRIDE,
                                            peaks)
    print(f"portbench: traced {run.trace['iters']} pool iterations, "
          f"{run.trace['device_ops']} device ops, busy "
          f"{run.trace['busy_s']:.4f} s of {run.trace['window_s']:.4f} s; "
          f"query ops on the device {run.trace['op_device_s']} s, bounds "
          f"{run.trace['bound_s']} s", file=sys.stderr, flush=True)


def all_reduce(value: float, op: str) -> float:
    """value reduced over the cell's process group ("sum" or "max")."""
    import torch
    import torch.distributed as dist
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    return float(t.item())


def drive_cell(cell, seed: int, seconds: float, trace: bool, t0: float,
               card: str, mix: dict, device, ranks=None):
    """Set-up, warm-up, window and traced calls of one rank of a run:
    (the Run, the scene). ranks: (rank, world) in the cell's process
    group, or None on one card."""
    import torch
    from portbench import drive
    from portbench.reference import scene as scene_mod
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stop = (None if ranks is None
            else lambda done: all_reduce(float(done), "max") > 0)

    t_program = time.perf_counter()
    scene = scene_mod.build(cell.config, cell.base)
    traffic, run = drive.start(mix, cell.config, scene, seed, device, ranks,
                               cell.base)
    run.card = card
    sync()
    t_state = time.perf_counter()
    for _ in range(int(mix.get("warmup_calls", 1))):
        traffic.call(None)
    sync()
    run.setup_s = time.perf_counter() - t0
    if ranks is None or ranks[0] == 0:
        print(f"portbench: setup {run.setup_s:.3f} s: to the program's "
              f"import {t_program - t0:.3f}, scene and state "
              f"{t_state - t_program:.3f}, warm-up "
              f"{t0 + run.setup_s - t_state:.3f}", file=sys.stderr,
              flush=True)
    with drive.count_iters(run) if trace else nullcontext():
        drive.window(traffic, run, seconds, sync, stop)
    if trace:
        traced(traffic, run, scene, sync, ranks)
    run.final = traffic.final()
    run.peak = torch.cuda.max_memory_allocated() if cuda else 0
    if ranks is not None:
        run.peak = int(all_reduce(run.peak, "max"))
    del traffic
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ranks is not None:
        check_ranks_modules(ranks)
    return run, scene


def check_ranks_modules(ranks) -> None:
    """Ranks 1 .. n-1 held to main()'s rule for rank 0's modules, once
    their window has closed: a rank that loaded JAX or the JAX package
    names them, and rank 0 raises, so that the run prints no result."""
    found = forbidden_modules() if ranks[0] else []
    if found:
        print(f"portbench: rank {ranks[0]} loaded modules of JAX or the "
              f"JAX package: {found}", file=sys.stderr, flush=True)
    if all_reduce(float(bool(found)), "max") > 0 and ranks[0] == 0:
        raise RuntimeError("a rank loaded modules of JAX or the JAX "
                           "package")


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float,
             card: str = "", mix=None, settings=None) -> dict:
    """One run of `cell` on `device` ("cuda" or "cpu"; on `cell.chips`
    cards or CPU ranks, as launch.py starts them): the result line's
    object. mix and settings replace the cell's traffic mix and check
    settings (the tests run the harness at small sizes on the CPU)."""
    import torch
    from portbench import check, harness, launch
    mix = mix or cell.traffic
    settings = settings or cell.check
    args = (cell, seed, seconds, trace, t0, card, mix)
    if cell.chips > 1:
        with launch.Group(cell.chips, torch.device(device).type,
                          args) as dev:
            run, scene = drive_cell(*args, device=dev,
                                    ranks=(0, cell.chips))
    else:
        run, scene = drive_cell(*args, device=device)
    ms = sorted(1e3 * (c["t1"] - c["t0"]) for c in run.calls)
    print(f"portbench: {len(ms)} calls in "
          f"{run.calls[-1]['t1'] - run.window_start:.3f} s; ms per call: "
          f"least {ms[0]:.1f}, median {ms[len(ms) // 2]:.1f}, most "
          f"{ms[-1]:.1f}; in order: "
          f"{[round(1e3 * (c['t1'] - c['t0']), 1) for c in run.calls]}",
          file=sys.stderr, flush=True)

    numbers = check.compare(run, settings, cell.config, mix, scene, seed,
                            device, base=cell.base)
    metrics = {}
    for m in cell.metrics(trace):
        value = harness.reader(m["name"], cell.base)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
           "count": cell.chips, "memory_peak_bytes": int(run.peak)}
    # a call that fails raises, and the run prints no result
    result = {"correct": bool(check.correct(numbers)),
              "attempted": len(run.calls), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    cell = harness.Cell(harness.manifest(), args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    card = torch.cuda.get_device_name(0)
    print(f"portbench: {cell.name} on {torch.cuda.device_count()} x {card}",
          file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0, card)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
