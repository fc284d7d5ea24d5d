"""The process group of a cell on several cards. A cell's `chips` in
BENCHMARK.json decides: on one card the run is one process; on n, the
run's own process is rank 0 and starts ranks 1 .. n-1, one process per
card (rank r on card r), all in one torch.distributed group (NCCL on
cards, gloo on the CPU in the tests) at tcp://localhost on a free port.
Every rank makes the same calls (SPMD); rank 0 alone measures, checks
and prints. On leaving, rank 0 takes its own group down before it waits
for any rank, since NCCL's teardown waits for every rank of the group:
after a clean run it destroys the group, then joins the ranks it started
(where the destroy outlives JOIN_S, it ends the ranks and exits at once,
with no result); after a failure it ends those ranks first (terminate,
then kill), then aborts its group (NCCL) or destroys it (gloo), which
waits on no rank.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import sys
import threading
import time

TIMEOUT_S = 300     # a collective that waits longer fails the run
JOIN_S = 120        # the teardown and the ranks' own end, after rank 0's
KILL_S = 10         # a terminated rank's end before it is killed
EXIT_HUNG = 5       # rank 0's exit code when its own destroy outlives JOIN_S


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


def leave(failed: bool) -> None:
    """Take this process's group down. After a failure under NCCL it is
    aborted, which waits on no other rank; otherwise destroyed, which
    under NCCL returns once every rank of the group destroys it too."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return
    if failed and dist.get_backend() == "nccl":
        dist.distributed_c10d._abort_process_group()
    else:
        dist.destroy_process_group()


def _rank(rank, world, port, device_type, threads, args):
    import torch

    from portbench import run as bench_run
    torch.set_num_threads(threads)
    device = join(rank, world, port, device_type)
    failed = True
    try:
        bench_run.drive_cell(*args, device=device, ranks=(rank, world))
        failed = False
    finally:
        leave(failed)


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

    def end_ranks(self) -> None:
        """Terminate the ranks still alive, and kill those that outlive
        KILL_S."""
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + KILL_S
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()

    def give_up(self) -> None:
        """Rank 0's destroy has waited JOIN_S for a rank that never
        destroys its group: end the ranks, then this process. Under NCCL
        the destroy may go on waiting for ranks that are gone; ending the
        process bounds it whatever the backend does."""
        print(f"portbench: the process group's teardown outlived {JOIN_S} "
              f"s; ranks 1..{self.world - 1} ended, no result",
              file=sys.stderr, flush=True)
        self.end_ranks()
        os._exit(EXIT_HUNG)

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            # the ranks wait in their own destroy for rank 0's
            deadline = time.monotonic() + JOIN_S
            watchdog = threading.Timer(JOIN_S, self.give_up)
            watchdog.start()
            try:
                leave(failed=False)
            finally:
                watchdog.cancel()
                watchdog.join()
            for p in self.procs:
                p.join(max(0.0, deadline - time.monotonic()))
            self.end_ranks()
        else:
            self.end_ranks()
            leave(failed=True)
        bad = [p.exitcode for p in self.procs if p.exitcode != 0]
        if bad and exc_type is None:
            raise RuntimeError(f"ranks 1..{self.world - 1} ended with "
                               f"exit codes {bad}")
        return False
