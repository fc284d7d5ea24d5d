"""Several ranks of one process group on one host, for the tests and the
smoke run (users start their ranks with torchrun).

    run_sharded(world, calls, device=..., backend="gloo")

spawns `world` processes (start method spawn), joins them into one group
through a file:// store in a temporary directory (no TCP port to collide
with another run), has each rank load the calls' states from checkpoints
written there (utils/checkpoint, no pickle) onto `device`, run the calls
with parallel.render, and returns rank 0's results. A rank's failure is
raised in the caller.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.parallel import render as par
from tracer_tpu_torch.utils import checkpoint

CALLS = ("render_pooled_sharded", "sample_points_sharded", "step_sharded",
         "merge_points_newest")


def run_sharded(world: int, calls, *, device="cuda", backend: str = "gloo",
                threads: int | None = None) -> list:
    """Run calls on `world` ranks, each a (name, (n_tile, n_sample),
    state, arg) over all of them:
      render_pooled_sharded, sample_points_sharded   arg = spp
      step_sharded            arg = steps, each from the last one's state
      merge_points_newest     state None, arg = (pos (S, 3, N), distance
                              (S, N), inten (S, N)): replica si merges
                              row si
    Returns, per call, rank 0's {"out": the result on the CPU (a step's:
    the last image; a merge's: {"pos", "inten", "best_d"}), "seconds":
    its wall from a barrier to the result on the host, "launches" /
    "plain_calls": {kernel of cuda_lib.KERNELS: [count on each rank]}},
    and for step_sharded "nonce" and "n_frames". device: "cuda" puts rank
    r on card r modulo the cards there are, "cuda:i" every rank on card
    i, "cpu" on the host. threads: torch's CPU threads in each rank."""
    for name, (n_tile, n_sample), _, _ in calls:
        if name not in CALLS:
            raise ValueError(f"unknown call {name!r}")
        if n_tile * n_sample != world:
            raise ValueError(f"mesh {n_tile}x{n_sample} is not the world "
                             f"of {world} ranks")
    with tempfile.TemporaryDirectory() as tmp:
        paths, jobs = {}, []
        for name, shape, state, arg in calls:
            if state is not None and id(state) not in paths:
                paths[id(state)] = os.path.join(tmp, f"state{len(paths)}.npz")
                checkpoint.save(paths[id(state)], state)
            jobs.append((name, tuple(shape),
                         None if state is None else paths[id(state)], arg))
        out = os.path.join(tmp, "result.pt")
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, backend, os.path.join(tmp, "store"), out,
                       threads, str(device), jobs))
        return torch.load(out, weights_only=True)


def _rank_main(rank, world, backend, store, out, threads, device, jobs):
    if threads:
        torch.set_num_threads(threads)
    device = torch.device(device)
    if device.type == "cuda":
        index = (rank % torch.cuda.device_count() if device.index is None
                 else device.index)
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        meshes, states, results = {}, {}, []
        for name, shape, path, arg in jobs:
            if shape not in meshes:
                meshes[shape] = par.make_mesh(*shape)
            if path is not None and path not in states:
                states[path] = checkpoint.load(path, device=device)
            results.append(_run(name, states.get(path), meshes[shape], arg,
                                rank, world, device))
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(name, s, mesh, arg, rank, world, device) -> dict:
    """One call on this rank, timed, with every rank's kernel counts."""
    extra = {}
    _sync(device)
    dist.barrier()
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    if name == "step_sharded":
        for _ in range(arg):
            s = par.step_sharded(s, mesh)
        out = s.img
        extra = {"nonce": s.nonce, "n_frames": s.n_frames}
    elif name == "merge_points_newest":
        pos, distance, inten = (torch.as_tensor(x[mesh.si], device=device)
                                for x in arg)
        out = dict(zip(("pos", "inten", "best_d"), par.merge_points_newest(
            pos, distance, inten, mesh.si, mesh)))
    else:
        out = getattr(par, name)(s, mesh, arg)
    _sync(device)
    secs = time.perf_counter() - t0
    names = cuda_lib.KERNELS
    counts = torch.zeros((world, 2, len(names)), dtype=torch.int64,
                         device=device)
    counts[rank, 0] = torch.tensor([cuda_lib.launches[k] for k in names])
    counts[rank, 1] = torch.tensor([cuda_lib.plain_calls[k] for k in names])
    dist.all_reduce(counts)
    counts = counts.cpu()
    cpu = ({k: v.cpu() for k, v in out.items()} if isinstance(out, dict)
           else out.cpu())
    return {"out": cpu, "seconds": secs, **extra,
            "launches": {k: counts[:, 0, i].tolist()
                         for i, k in enumerate(names)},
            "plain_calls": {k: counts[:, 1, i].tolist()
                            for i, k in enumerate(names)}}
