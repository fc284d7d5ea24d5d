"""Port parity: V3 linear algebra, spectra, triangle geometry and morton
codes of tracer_tpu_torch against the JAX package (rtol 1e-6)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tracer_tpu.ops import linalg as jla, morton as jmorton
from tracer_tpu.ops import shapes as jshapes, spectrum as jspec
from tracer_tpu_torch.ops import linalg as tla, morton as tmorton
from tracer_tpu_torch.ops import shapes as tshapes, spectrum as tspec

torch.set_num_threads(2)

N = 512
RTOL, ATOL = 1e-6, 1e-6


def _v3(r, scale=1.0):
    return (r.normal(size=(3, N)) * scale).astype(np.float32)


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["v3_dot", "v3_cross", "v3_norm",
                                  "v3_normalize", "v3_same_side",
                                  "v3_to_array"])
def test_linalg_v3(name):
    r = np.random.default_rng(1)
    a, b = _v3(r), _v3(r)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    if name in ("v3_norm", "v3_normalize", "v3_to_array"):
        j, t = getattr(jla, name)(ja), getattr(tla, name)(ta)
    else:
        j, t = getattr(jla, name)(ja, jb), getattr(tla, name)(ta, tb)
    _close(j, t)
    if name == "v3_to_array":
        _close(jla.v3_from_array(j), tla.v3_from_array(t))


def test_lookup_pairs_and_spectra():
    r = np.random.default_rng(2)
    v = r.uniform(100, 2100, N).astype(np.float32)
    v[:6] = [150.0, 460.0, 550.0, 610.0, 1000.0, 2000.0]  # exact knots
    for s in (jspec.bright_blue_sky(), jspec.blackbody_normalized(5500.0),
              jspec.uniform_spectrum(3.0), jspec.no_sky()):
        j = jspec.lookup(jnp.asarray(v), jnp.asarray(s))
        t = tspec.lookup_table(torch.as_tensor(v), torch.as_tensor(s))
        _close(j, t)
    np.testing.assert_array_equal(jspec.bright_blue_sky(),
                                  tspec.bright_blue_sky())
    np.testing.assert_array_equal(jspec.blackbody_normalized(5500.0),
                                  tspec.blackbody_normalized(5500.0))
    np.testing.assert_array_equal(jspec.no_sky(), tspec.no_sky())
    # per-lane knots with sentinels, as the material rows carry them
    knots = r.uniform(300, 900, (6, 2, N)).astype(np.float32)
    knots[4:, 0] = -1.0
    jp = [(jnp.asarray(knots[k, 0]), jnp.asarray(knots[k, 1])) for k in range(6)]
    tp = [(torch.as_tensor(knots[k, 0]), torch.as_tensor(knots[k, 1]))
          for k in range(6)]
    _close(jspec.lookup_pairs(jnp.asarray(v), jp),
           tspec.lookup_pairs(torch.as_tensor(v), tp))


def test_hit_triangle_v_and_acne_offset():
    r = np.random.default_rng(3)
    o = _v3(r, 2.0)
    d = _v3(r)
    d /= np.linalg.norm(d, axis=0)
    ta = _v3(r, 2.0)
    tb = ta + _v3(r)
    tc = ta + _v3(r)
    # aim half the rays at their triangle's centroid
    tgt = (ta + tb + tc) / 3
    aim = (tgt - o) / np.linalg.norm(tgt - o, axis=0)
    d[:, ::2] = aim[:, ::2]
    tmax = r.uniform(0.5, 8.0, N).astype(np.float32)
    J = jshapes.hit_triangle_v(jnp.asarray(tmax), jnp.asarray(o),
                               jnp.asarray(d), jnp.asarray(ta),
                               jnp.asarray(tb), jnp.asarray(tc))
    T = tshapes.hit_triangle_v(torch.as_tensor(tmax), torch.as_tensor(o),
                               torch.as_tensor(d), torch.as_tensor(ta),
                               torch.as_tensor(tb), torch.as_tensor(tc))
    ok = np.asarray(J[0])
    assert ok.sum() > N // 8
    np.testing.assert_array_equal(T[0].numpy(), ok)
    for j, t in zip(J[1:], T[1:]):
        _close(j, t)
    jo, jd = jshapes.mkray_adjust_acne_v(J[2], J[3], jnp.asarray(d))
    to, td = tshapes.mkray_adjust_acne_v(T[2], T[3], torch.as_tensor(d))
    _close(jo, to)
    _close(jd, td)


def test_morton3d_exact():
    r = np.random.default_rng(4)
    p = r.uniform(-0.1, 1.1, (N, 3)).astype(np.float32)
    p[0] = [np.nan, 0.5, 1.0]
    j = np.asarray(jmorton.morton3d(jnp.asarray(p))).astype(np.int64)
    t = tmorton.morton3d(torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(j, t)
