"""Seconds from the process's start to the first measured call: imports,
CUDA context, the kernel library's load (its build in a fresh
checkout), the scene and state, and the warm-up call."""


def read(run):
    return run.setup_s
