"""LiDAR batch capture: the port of frontends/save_demo.py (the
reference's demo-save, demo-save/src/main.rs:12-32).

    python -m tracer_tpu_torch.frontends.save_demo [--device cuda] \\
        [-W 640] [-H 480] [-s 100] [-c 2] [--out dump.pcd] [--png out.png]

Defaults are the reference's: 640x480, sensor config 2 (LiDAR), 100
samples per pixel, camera at (0, 0.8, 1.8), ASCII PCD output, written by
the native host library (utils/native.py) when it builds, else by
utils/pcd.py, and the writer that ran is printed. The scene
is --obj, else CornellBox-Original.obj under $TRACER_ASSETS when it is
there, else the procedural Cornell box (utils/testscenes.cornell_like).
--png also writes a --png-frames progressive image. It runs on the CUDA
card unless --device names another (--device cpu runs the kernels'
plain versions).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

CAM_ORIGIN = (0.0, 0.8, 1.8)


def load_scene(obj_path):
    """(tris, tri_mats, mats) and the scene's name: obj_path, else
    CornellBox-Original.obj under $TRACER_ASSETS, else cornell_like."""
    if obj_path is None:
        assets = os.environ.get("TRACER_ASSETS")
        path = (os.path.join(assets, "CornellBox-Original.obj")
                if assets else None)
        obj_path = path if path and os.path.exists(path) else None
    if obj_path is not None:
        from tracer_tpu_torch.utils.objloader import load_obj
        return load_obj(obj_path), obj_path
    from tracer_tpu_torch.utils.testscenes import cornell_like
    return cornell_like(), "procedural cornell_like"


def main(argv=None):
    ap = argparse.ArgumentParser(description="tracer_tpu_torch LiDAR capture")
    ap.add_argument("-o", "--obj", default=None)
    ap.add_argument("-W", "--width", type=int, default=640)
    ap.add_argument("-H", "--height", type=int, default=480)
    ap.add_argument("-s", "--spp", type=int, default=100)
    ap.add_argument("-c", "--conf", type=int, default=2)
    ap.add_argument("--out", default="dump.pcd")
    ap.add_argument("--png", default=None,
                    help="also render a --png-frames progressive image")
    ap.add_argument("--png-frames", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    import tracer_tpu_torch as T
    from tracer_tpu_torch.utils import native, pcd
    from tracer_tpu_torch.utils.image import write_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card; pass --device cpu to run on the CPU")
    (tris, tm, mats), name = load_scene(args.obj)
    print(f"scene {name}: {tris.shape[0]} triangles")
    state = T.init(0, args.height, args.width, args.conf, tris, tm, mats,
                   cam_origin=CAM_ORIGIN, device=device)

    t0 = time.perf_counter()
    state, points = T.sample_points_n(state, args.spp)
    points = points.cpu().numpy()
    print(f"captured {points.shape[1]}x{points.shape[0]} points "
          f"@ {args.spp} spp in {time.perf_counter() - t0:.1f}s "
          f"({(points[..., 3] > 0).mean() * 100:.1f}% returns) on {device}")
    if native.available():
        native.write_pcd(args.out, points)
        writer = "native"
    else:
        pcd.write_pcd(args.out, points)
        writer = "python"
    print(f"wrote {args.out} ({writer} PCD writer)")

    if args.png:
        img = T.sample_n_frames(state, args.png_frames).cpu().numpy()
        write_png(args.png, img)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
