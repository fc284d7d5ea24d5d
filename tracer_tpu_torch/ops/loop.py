"""A loop whose exit test stays on the device when the loop is traced.

The pool of the path integrator (engine/integrator.py) and the LBVH walk
(ops/bvh.py) loop until a test of the whole batch fails. Run eagerly,
that test is a host read, so they make it only where it can fail: from
a given step on, every so many steps. Traced by torch.export or
torch.compile, a host read is impossible, and the loop is torch's
while_loop, which the captured program runs with its test on the device
(the JAX package's lax.while_loop). One body serves both loops.

Eagerly, each step is span <name>.iter and each read of the test the
host read <name>.exit (utils/profiling), for the name the caller gives:
"pool" for the path integrator's pool, "lbvh" for the walk.
"""

from __future__ import annotations

import torch

from tracer_tpu_torch.utils import profiling


def _traced() -> bool:
    return torch.compiler.is_compiling()


def _while_loop(cond, body, carry: tuple):
    from torch._higher_order_ops import while_loop
    return while_loop(cond, body, carry)


def run(cond, body, carry: tuple, max_steps: int, *, name: str,
        check_from: int = 0, check_every: int = 1) -> tuple:
    """carry = body(*carry) while cond(*carry), a 0-d bool tensor.

    Traced (torch.compiler.is_compiling()): torch's while_loop, which
    tests cond before every step; cond itself must end the loop by
    max_steps, and body must return new tensors of the carry's shapes and
    dtypes. Eager: at most max_steps steps, cond read on the host only
    before steps k >= check_from with (k - check_from) % check_every ==
    0; name names its spans (above). The caller makes the two agree:
    cond holds before every step it does not test, or a step after cond
    fails changes nothing."""
    if _traced():
        return tuple(_while_loop(cond, body, tuple(carry)))
    step, exit_site = f"{name}.iter", f"{name}.exit"
    for k in range(max_steps):
        if k >= check_from and (k - check_from) % check_every == 0:
            with profiling.host_read(exit_site):
                more = bool(cond(*carry))
            if not more:
                break
        with profiling.span(step):
            carry = body(*carry)
    return tuple(carry)
