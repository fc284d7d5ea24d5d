"""The process group of a cell on several cards. A cell's `chips` in
BENCHMARK.json decides: on one card the run is one process; on n, the
run's own process is rank 0 and starts ranks 1 .. n-1, one process per
card (rank r on card r), all in one torch.distributed group (NCCL on
cards, gloo on the CPU in the tests) at tcp://localhost on a free port.
Every rank makes the same calls (SPMD); rank 0 alone measures, checks
and prints. On leaving, rank 0 waits for every rank it started, and ends
them where it failed.
"""

from __future__ import annotations

import datetime
import multiprocessing
import socket

TIMEOUT_S = 300     # a collective that waits longer fails the run
JOIN_S = 120        # the ranks' own end, after rank 0's


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join(rank: int, world: int, port: int, device_type: str):
    """Join the group as `rank`; returns the rank's device."""
    import torch
    import torch.distributed as dist
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def _rank(rank, world, port, device_type, threads, args):
    import torch
    import torch.distributed as dist

    from portbench import run as bench_run
    torch.set_num_threads(threads)
    device = join(rank, world, port, device_type)
    try:
        bench_run.drive_cell(*args, device=device, ranks=(rank, world))
    finally:
        dist.destroy_process_group()


class Group:
    """with Group(world, device_type, args) as device: rank 0's device,
    ranks 1 .. world-1 started on drive_cell(*args)."""

    def __init__(self, world: int, device_type: str, args: tuple):
        self.world, self.device_type, self.args = world, device_type, args

    def __enter__(self):
        import torch
        port = free_port()
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank, args=(
            r, self.world, port, self.device_type, torch.get_num_threads(),
            self.args)) for r in range(1, self.world)]
        for p in self.procs:
            p.start()
        return join(0, self.world, port, self.device_type)

    def __exit__(self, exc_type, *exc):
        import torch.distributed as dist
        for p in self.procs:
            if exc_type is not None:
                p.terminate()
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
        dist.destroy_process_group()
        bad = [p.exitcode for p in self.procs if p.exitcode != 0]
        if bad and exc_type is None:
            raise RuntimeError(f"ranks 1..{self.world - 1} ended with "
                               f"exit codes {bad}")
        return False
