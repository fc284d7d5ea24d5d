"""Time parallel/render.py's sharded calls beside the same calls on one
card.

    python -m tracer_tpu_torch.utils.parallel_timing [--world 4]
        [--backend nccl] [--device cuda] [--repeats 3]

Prints each card's name and power limit (nvidia-smi), then one JSON line
per call. The sharded walls are rank 0's host clock from a barrier to the
result on the host (parallel/local.run_sharded: `world` ranks, rank r on
card r modulo the cards there are; --device cuda:0 puts every rank on
card 0, where NCCL refuses two ranks: use --backend gloo). The single
walls are the same call on one process and card 0, closed by
torch.cuda.synchronize(), after a warm-up. Each rank takes its share
of the host's cores for torch's CPU threads. Each call runs `repeats`
times on each side, and every wall is printed. The results are held as
chip_smoke.py holds them: a tile-only mesh bit for bit, a sample mesh
within rtol 1e-5; points with equal returns and positions, intensity
within rtol 1e-6.

Calls, on chip_smoke.py's cells: render_pooled_sharded of the 512x512
Cornell box at 16 spp over (world, 1) and (world / 2, 2); 3 step_sharded
frames with the accumulation on over (world, 1); sample_points_sharded of
the 640x480 100-spp capture over (world / 2, 2).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

import tracer_tpu_torch as T
from tracer_tpu_torch.engine import integrator, keys
from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.parallel import local
from tracer_tpu_torch.utils import testscenes

SIZE, SPP = 512, 16
LIDAR_W, LIDAR_H, LIDAR_SPP = 640, 480, 100
STEPS = 3
CAM_ORIGIN = (0.0, 0.8, 1.8)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _single(name, s, arg):
    """The single-process counterpart of a sharded call."""
    if name == "render_pooled_sharded":
        w, h = s.sub_dims
        return integrator.render_pooled(
            s.seed, s.nonce, s.scene, s.cam, s.ambience, w, h,
            s.transmitter_kind, arg, s.render_mode)["img"]
    if name == "step_sharded":
        for _ in range(arg):
            s = T.step(s)
        return s.img
    return T.sample_points_n(s, arg)[1]


def _agree(name, shape, got, want) -> bool:
    if name == "sample_points_sharded":
        def has(p):
            return ~((p[..., :3] == -1).all(-1) & (p[..., 3] == 0))
        return (torch.equal(has(got), has(want))
                and torch.equal(got[..., :3], want[..., :3])
                and bool(torch.isclose(got[..., 3], want[..., 3], rtol=1e-6,
                                       atol=0.0).all()))
    if shape[1] == 1:
        return torch.equal(got, want)
    return bool(torch.isclose(got, want, rtol=1e-5, atol=0.0).all())


def calls(world: int, device) -> list:
    """The timed calls, (name, mesh shape, state, arg), on `device`."""
    arrays = testscenes.cornell_like()
    s = T.init(0, SIZE, SIZE, 0, *arrays, cam_origin=CAM_ORIGIN,
               device=device)
    sm = T.key(keys.KEYDOWN, keys.SDLK_SPACE, s)
    sl = T.init(0, LIDAR_H, LIDAR_W, 2, *arrays, cam_origin=CAM_ORIGIN,
                device=device)
    return [("render_pooled_sharded", (world, 1), s, SPP),
            ("render_pooled_sharded", (world // 2, 2), s, SPP),
            ("step_sharded", (world, 1), sm, STEPS),
            ("sample_points_sharded", (world // 2, 2), sl, LIDAR_SPP)]


def cards() -> list[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if args.world % 2:
        raise SystemExit("--world must be even (a sample axis of 2)")
    base = torch.device(args.device)
    single_dev = torch.device("cuda", 0) if base.type == "cuda" else base
    if base.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("parallel_timing needs a CUDA card, or "
                             "--device cpu --backend gloo")
        for line in cards():
            print(line, flush=True)
        cuda_lib.load()   # once, before the ranks load it
    todo = calls(args.world, single_dev)
    singles = []
    for name, shape, s, arg in todo:
        _single(name, s, 1)   # warm-up
        walls = []
        for _ in range(args.repeats):
            _sync(single_dev)
            t0 = time.perf_counter()
            out = _single(name, s, arg)
            _sync(single_dev)
            walls.append(time.perf_counter() - t0)
        singles.append((out.cpu(), walls))
    warm = [(n, sh, s, 2 if n != "step_sharded" else 1)
            for n, sh, s, _ in todo]
    sharded = local.run_sharded(
        args.world, warm + [c for c in todo for _ in range(args.repeats)],
        device=base, backend=args.backend,
        threads=max(1, os.cpu_count() // args.world))[len(warm):]
    disagree = []
    for i, (name, shape, _, arg) in enumerate(todo):
        runs = sharded[i * args.repeats:(i + 1) * args.repeats]
        want, walls = singles[i]
        agree = all(_agree(name, shape, r["out"], want) for r in runs)
        if not agree:
            disagree.append(f"{name} {shape}")
        print(json.dumps({
            "call": name, "mesh": shape, "arg": arg, "world": args.world,
            "backend": args.backend, "device": str(base),
            "sharded_s": [r["seconds"] for r in runs], "single_s": walls,
            "agree": agree,
            "k1_launches_per_rank": runs[0]["launches"]["closest_hit"],
            "k3_launches_per_rank": runs[0]["launches"]["any_hit"]}),
            flush=True)
    if disagree:
        raise SystemExit(f"sharded results differ from one card's: "
                         f"{disagree}")


if __name__ == "__main__":
    main()
