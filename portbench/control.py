"""The control of the check: the reference in the nearest precision
below the configuration's (TF32 ray-triangle tests for float32), put in
the program's place, read by the same comparison as a run's answers.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--calls 14] [--frames 80]

prints, per seed, each number compared and its limit. It drives no
program: the answers of `--calls` offline calls (their nonces as a
run's window gives them) or of `--frames` viewer frames come from the
control. A limit is sound when every seed's control reads above it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, calls: int, frames: int, device,
             mix=None, settings=None) -> dict:
    """{number: (value, limit)} of the control for one seed."""
    from portbench import check, drive, harness
    from portbench.reference import scene as scene_mod
    mix = mix or cell.traffic
    settings = settings or cell.check
    scene = scene_mod.build(cell.config, cell.base)
    entry = harness.entry(mix["entry"], cell.base)
    w, h, spp = int(mix["width"]), int(mix["height"]), int(mix["spp"])
    run = drive.Run(mix["entry"], entry.KIND, w, h, spp, w * h * spp)
    entry.control_run(run, calls, frames)
    ctrl = check.Reference(cell.config, mix, scene, seed, device,
                           precision="tf32")
    return check.compare(run, settings, cell.config, mix, scene, seed,
                         device, control=ctrl, base=cell.base)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=14)
    ap.add_argument("--frames", type=int, default=80)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    cell = harness.Cell(harness.manifest(), args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = readings(cell, seed, args.calls, args.frames, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": {k: {"value": v, "limit": lim}
                                      for k, (v, lim) in nums.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
