"""Measure the relative error of the approximate reciprocal (K5) on a
device: the port of benchmarks/measure_recip.py.

    python -m tracer_tpu_torch.utils.measure_recip [n] [--device cuda]

The inputs are the JAX script's: n = 2^20 by default, seed 7, exponents
uniform in [-20, 20), mantissas uniform in [1, 2), both signs. On the
CUDA card (the default) they go through the hand kernel
(ops/recip.approx_reciprocal); --device cpu runs its plain version,
torch.reciprocal. Prints one JSON line with the JAX script's keys,
{"backend", "kernel", "n", "max_rel", "p999_rel", "log2_max"}, where
"kernel" is true when the kernel ran (in place of the JAX "interpret").
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def inputs(n: int) -> np.ndarray:
    """(n,) f32, as benchmarks/measure_recip.py makes them."""
    rng = np.random.default_rng(7)
    # span all magnitudes the intersector's determinant takes
    return (rng.uniform(1.0, 2.0, n) * np.exp2(rng.uniform(-20, 20, n))
            * rng.choice([-1.0, 1.0], n)).astype(np.float32)


def measure(n: int = 1 << 20, device="cuda") -> dict:
    """Run approx_reciprocal on the inputs on `device` and report the
    relative error against the float64 1/x."""
    import torch
    from tracer_tpu_torch.ops import cuda_lib, recip
    device = torch.device(device)
    x = inputs(n)
    before = cuda_lib.launches[recip.NAME]
    y = recip.approx_reciprocal(torch.as_tensor(x, device=device))
    y = y.cpu().numpy()
    exact = 1.0 / x.astype(np.float64)
    rel = np.abs(y.astype(np.float64) - exact) / np.abs(exact)
    return {
        "backend": device.type,
        "kernel": cuda_lib.launches[recip.NAME] > before,
        "n": n,
        "max_rel": float(rel.max()),
        "p999_rel": float(np.quantile(rel, 0.999)),
        "log2_max": float(np.log2(rel.max())) if rel.max() > 0 else None,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=1 << 20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card; pass --device cpu to run on the CPU")
    print(json.dumps(measure(args.n, args.device)))


if __name__ == "__main__":
    main()
