"""tracer_tpu_torch — the PyTorch / CUDA port of tracer_tpu.

The same spectral Monte Carlo path tracer as the JAX package beside it,
run eagerly in PyTorch, with the two intersection kernels written by
hand in CUDA C++ for Hopper (csrc/intersect.cu). The layout mirrors
tracer_tpu:

  engine/    public API (init/step/render/key/resize/sample_n_frames/
             step_render), engine state, per-frame wavefront integrator,
             NEE+MIS direct lighting
  models/    camera, sensor configs, lights, scene assembly
  ops/       vector math, counter-based RNG, spectra, geometry,
             materials, dense intersector and its kernel wrappers
  utils/     OBJ loader, procedural test scenes, conversion of a JAX
             engine state into this package's state, the kernels' test
             cases
  csrc/      CUDA C++ kernel sources, built with nvcc at first use

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
