"""tracer_tpu_torch — the PyTorch / CUDA port of tracer_tpu.

The same spectral Monte Carlo path tracer and LiDAR sensor simulator as
the JAX package beside it, run eagerly in PyTorch, with its kernels
written by hand in CUDA C++ for Hopper: the four intersection kernels
(csrc/intersect.cu) and the approximate-reciprocal probe (csrc/recip.cu).
The layout mirrors tracer_tpu:

  engine/     public API (init/step/render/key/resize/sample_n_frames/
              sample_points_n/step_render), engine state, the wavefront
              integrator (the pooled render with lane refill, and the
              per-frame version it is held against), NEE+MIS direct
              lighting with the sensors' transmitter fan
  models/     camera, sensor configs, lights, scene assembly
  ops/        vector math, counter-based RNG, spectra, geometry,
              materials, dense intersector, the kernels' wrappers and
              their build (cuda_lib), the LBVH (radix_tree, bvh)
  parallel/   multi-device rendering on torch.distributed (a tile x
              sample mesh of ranks), and a launcher of ranks on one host
  utils/      OBJ loader (native or Python), the native host library's
              bindings, procedural test scenes, PCD and PNG writers,
              conversion of a JAX engine state into this package's state,
              checkpoint, profiling, the kernels' test cases and timing,
              the pool's timing, the reciprocal probe
  frontends/  the LiDAR capture (python -m
              tracer_tpu_torch.frontends.save_demo) and the interactive
              viewer (python -m tracer_tpu_torch.frontends.interactive)
  csrc/       CUDA C++ kernel sources, built with nvcc at first use
  native/     the C++ host library (OBJ/MTL loader, PCD writer), built
              with g++ at first use

The entry points run on the CUDA card unless the caller names another
device.

The package imports torch and numpy, never jax nor the JAX package.
"""

__version__ = "0.1.0"

_API = ("init", "step", "render", "key", "resize",
        "sample_points_n", "sample_n_frames", "step_render")


def __getattr__(name):
    """Lazily expose the entry points so importing a subpackage does not
    pull in the whole engine."""
    if name in _API:
        from tracer_tpu_torch.engine import api
        return getattr(api, name)
    raise AttributeError(name)
