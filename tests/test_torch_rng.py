"""Port parity: tracer_tpu_torch.ops.rng is bit-exact with the JAX RNG."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tracer_tpu.ops import rng as jrng
from tracer_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

N = 4096


def _states():
    r = np.random.default_rng(11)
    s = r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    s[:8] = [0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 - 2, 0xDEADBEEF, 7, 2 ** 31 - 1]
    return s


def _lane_ids():
    ids = np.arange(N, dtype=np.uint64)
    ids[N // 2:] += 2 ** 32 - N // 2  # the top half ends at 2^32 - 1
    return ids.astype(np.uint32)


def _np(x):
    return np.asarray(x)


def _eq(jx, tx):
    j = _np(jx)
    t = tx.numpy()
    if j.dtype == np.uint32 or j.dtype == np.int32:
        np.testing.assert_array_equal(j.astype(np.int64), t.astype(np.int64))
    else:
        np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("seed,frame", [(0, 0), (7, 12345), (2 ** 32 - 1, 2 ** 32 - 1)])
def test_make_streams_and_hash(seed, frame):
    ids = _lane_ids()
    _eq(jrng.make_streams(seed, frame, jnp.asarray(ids)),
        trng.make_streams(seed, frame, torch.as_tensor(ids.astype(np.int64))))
    _eq(jrng.hash_u32(jnp.asarray(ids)),
        trng.hash_u32(torch.as_tensor(ids.astype(np.int64))))


_DRAWS = {
    "next_u32": (lambda m, s: m.next_u32(s)),
    "next_unit": (lambda m, s: m.next_unit(s)),
    "next_uniform": (lambda m, s: m.next_uniform(s, -1.5, 2.25)),
    "in_unit_square": (lambda m, s: m.in_unit_square(s)),
    "in_triangle": (lambda m, s: m.in_triangle(s)),
    "select": (lambda m, s: m.select(s, 7)),
    "select_1": (lambda m, s: m.select(s, 1)),
}


@pytest.mark.parametrize("name", sorted(_DRAWS))
def test_draws_bit_exact(name):
    s = _states()
    js, jv = _DRAWS[name](jrng, jnp.asarray(s))
    ts, tv = _DRAWS[name](trng, torch.as_tensor(s.astype(np.int64)))
    _eq(js, ts)
    jv = jv if isinstance(jv, tuple) else (jv,)
    tv = tv if isinstance(tv, tuple) else (tv,)
    for a, b in zip(jv, tv):
        _eq(a, b)


def test_threefry_and_salted_pair():
    s = _states()
    x1 = _lane_ids()
    j0, j1 = jrng.threefry2x32(0x12345678, 0xFFFFFFFF, jnp.asarray(s),
                               jnp.asarray(x1))
    t0, t1 = trng.threefry2x32(0x12345678, 0xFFFFFFFF,
                               torch.as_tensor(s.astype(np.int64)),
                               torch.as_tensor(x1.astype(np.int64)))
    _eq(j0, t0)
    _eq(j1, t1)
    j0, j1 = jrng.salted_pair(jnp.asarray(s), 0x3C6EF372)
    t0, t1 = trng.salted_pair(torch.as_tensor(s.astype(np.int64)), 0x3C6EF372)
    _eq(j0, t0)
    _eq(j1, t1)
