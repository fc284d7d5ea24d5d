"""Port parity: scene assembly (build_scene) and closest_interaction of
tracer_tpu_torch against the JAX package on the Cornell and prism
scenes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tracer_tpu as J
from tracer_tpu.models import camera as jcam, scene as jscene
from tracer_tpu.ops import rng as jrng
from tracer_tpu.utils import testscenes
from tracer_tpu_torch.models import camera as tcam, scene as tscene
from tracer_tpu_torch.ops import rng as trng, shapes as tshapes
from tracer_tpu_torch.utils import convert

torch.set_num_threads(2)

SCENES = {"cornell": (testscenes.cornell_like, (0.0, 0.8, 1.8)),
          "prism": (testscenes.prism_scene, (0.0, 0.9, 2.6))}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_scene(name):
    tris, tm, mats = SCENES[name][0]()
    js = jax.tree.map(np.asarray, jscene.build_scene(tris, tm, mats))
    ts = tscene.build_scene(tris, tm, mats, device="cpu")
    for f in ("tris", "mat_ix", "mat_rows", "tri_mat", "light_table"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), getattr(js, f))
    for f in ("kind", "tri", "theta", "emission"):
        np.testing.assert_array_equal(getattr(ts.lights, f).numpy(),
                                      getattr(js.lights, f))
    for f in ("color", "roughness", "metalness", "ref_ix", "opacity",
              "emission"):
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      getattr(js.materials, f))
    np.testing.assert_array_equal(ts.accel.perm.numpy(), js.accel.perm)
    np.testing.assert_allclose(ts.accel.coeffs.numpy(), js.accel.coeffs,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tscene.build_scene(tris, tm, mats, accel="lbvh", device="cpu")
    big, big_tm = testscenes.subdivide(tris, tm, levels=5)  # > 64 chunks
    with pytest.raises(NotImplementedError):
        tscene.build_scene(big, big_tm, mats, device="cpu")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_interaction(name):
    scene_fn, origin = SCENES[name]
    tris, tm, mats = scene_fn()
    js = J.init(0, 24, 24, 0, tris, tm, mats, cam_origin=origin)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    n = 24 * 24
    lane = np.arange(n)
    jx = (lane % 24).astype(np.float32)
    iy = (24 - lane // 24 - 1).astype(np.float32)
    st = jrng.make_streams(0, 3, jnp.arange(n, dtype=jnp.uint32))
    st, jwl, _ = jcam.sample_wavelength(st, js.cam.conf)
    _, jo, jd = jcam.sample_ray(st, js.cam, (jnp.float32(24), jnp.float32(24)),
                                jnp.asarray(jx), jnp.asarray(iy))
    ji = jscene.closest_interaction(js.scene, jnp.float32(3.4028235e38),
                                    jnp.broadcast_to(jo, (3, n)), jd, jwl)

    tst = trng.make_streams(0, 3, torch.arange(n))
    tst, twl, _ = tcam.sample_wavelength(tst, ts.cam.conf)
    _, to, td = tcam.sample_ray(tst, ts.cam, (24, 24), torch.as_tensor(jx),
                                torch.as_tensor(iy))
    ti = tscene.closest_interaction(ts.scene, tshapes.F32_HIGHEST,
                                    to.expand(3, n), td, twl)
    ok = np.asarray(ji.ok)
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(ti.ok.numpy(), ok)
    for a, b in [(ji.t, ti.t), (ji.pos, ti.pos), (ji.normal, ti.normal),
                 (ji.emission_at_wl, ti.emission_at_wl), *zip(ji.mat, ti.mat)]:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
