"""Time the pooled render (engine/integrator.render_pooled) on a CUDA
card: what the pool's constants rest on.

    python -m tracer_tpu_torch.utils.pool_timing [--parts sizes,step]
                                                 [--repeats 2]
                                                 [--factors 0.25,0.5,1,2,4]

Prints the card's name and power limit, then one JSON line per part.
Every wall is the host clock around one render_pooled call that ends in
torch.cuda.synchronize(), after a 1-spp warm-up; each setting is run
`repeats` times, the settings interleaved, and every wall is printed.

  sizes   the pool size P at `factors` times n lanes (n pixels; n/4, n/2,
          n, 2n and 4n unless given) on the three cells: the 512x512
          16-spp Cornell box, cornell-sub6 (subdivide(cornell_like, 6),
          streamed) and the 640x480 100-spp LiDAR capture: wall,
          iterations, live share of lane-iterations
  step    one sample per pixel (what `step` renders) at 800x600 and
          512x512 with P = n/4, n/2 and n
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tracer_tpu_torch.engine import integrator
from tracer_tpu_torch.utils import kernel_timing

CELLS = {
    "cornell-512-16spp": dict(levels=0, w=512, h=512, conf=0, spp=16),
    "cornell-sub6-512-16spp": dict(levels=6, w=512, h=512, conf=0, spp=16),
    "cornell-lidar-640x480-100spp": dict(levels=0, w=640, h=480, conf=2,
                                         spp=100),
}


def timed_pool(s, spp: int, pool: int, with_points: bool = False) -> dict:
    """One render_pooled call of state s with `pool` lanes (in place of
    integrator._pool_size's answer), timed to its synchronise."""
    w, h = s.sub_dims
    size = integrator._pool_size
    integrator._pool_size = lambda n, spp, t_pad: pool
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = integrator.render_pooled(
            s.seed, s.nonce + 1, s.scene, s.cam, s.ambience, w, h,
            s.transmitter_kind, spp, s.render_mode, with_points=with_points)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        integrator._pool_size = size
    return {"wall_s": wall, "iters": out["iters"],
            "rays_traced": out["rays_traced"], "pool": pool,
            "live_share": out["rays_traced"] / (3 * pool * out["iters"]),
            "mrays_per_s": out["rays_traced"] / wall / 1e6}


def sweep(s, spp: int, pools, repeats: int, with_points: bool = False) -> dict:
    """{"P=<pool>": [timed_pool rows]} for each pool size, the sizes
    interleaved, after a 1-spp warm-up."""
    timed_pool(s, 1, pools[0], with_points)
    rows = {f"P={p}": [] for p in pools}
    for _ in range(repeats):
        for p in pools:
            rows[f"P={p}"].append(timed_pool(s, spp, p, with_points))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="sizes,step")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--factors", default="0.25,0.5,1,2,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pool_timing needs a CUDA card")
    device = torch.device("cuda")
    print(kernel_timing.card_line(), flush=True)
    parts = args.parts.split(",")
    if "sizes" in parts:
        for name, cell in CELLS.items():
            n = cell["w"] * cell["h"]
            s = kernel_timing.sub_state(cell["levels"], cell["w"], device,
                                        conf=cell["conf"], height=cell["h"])
            rows = sweep(s, cell["spp"],
                         [int(f * n) for f in map(float,
                                                  args.factors.split(","))],
                         args.repeats, with_points=cell["conf"] == 2)
            print(json.dumps({"part": "sizes", "cell": name, "rows": rows}),
                  flush=True)
            del s
    if "step" in parts:
        for w, h in ((800, 600), (512, 512)):
            s = kernel_timing.sub_state(0, w, device, height=h)
            n = w * h
            rows = sweep(s, 1, [n // 4, n // 2, n], args.repeats)
            print(json.dumps({"part": "step", "size": [w, h], "rows": rows}),
                  flush=True)
            del s


if __name__ == "__main__":
    main()
