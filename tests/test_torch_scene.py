"""Port parity: scene assembly (build_scene, add_point_light) and
closest_interaction of tracer_tpu_torch against the JAX package on the
Cornell and prism scenes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tracer_tpu as J
from tracer_tpu.models import camera as jcam, scene as jscene
from tracer_tpu.ops import rng as jrng
from tracer_tpu.ops import spectrum as jspec
from tracer_tpu.utils import testscenes
from tracer_tpu_torch.models import camera as tcam, scene as tscene
import tracer_tpu_torch as T
from tracer_tpu_torch.ops import rng as trng, shapes as tshapes
from tracer_tpu_torch.ops import spectrum as tspec
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
    with pytest.raises(NotImplementedError,
                       match=r"LBVH accel .*\(ROADMAP\.md, Queue 1\)"):
        tscene.build_scene(tris, tm, mats, accel="lbvh", device="cpu")
    # the dense accel takes scenes above 64 chunks (superchunk walk)
    big, big_tm = testscenes.subdivide(tris, tm, levels=5)
    tb = tscene.build_scene(big, big_tm, mats, device="cpu")
    assert tb.accel.chunk_bounds.shape[0] == -(-big.shape[0] // 256) > 64
    np.testing.assert_array_equal(tb.tri_mat.numpy(),
                                  big_tm[tb.accel.perm[:big.shape[0]].numpy()])


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


def _dark_cornell():
    tris, tm, mats = testscenes.cornell_like()
    mats = mats.copy()
    mats[4, 16:28] = [-1, 0] * 6  # no area light
    return tris, tm, mats


@pytest.mark.parametrize("name", ["cornell", "prism", "dark"])
def test_add_point_light_matches_jax(name):
    """add_point_light appends the same light as the JAX package's: the
    lights and the packed light table are equal, on a scene with area
    lights and on one with none; every other tensor is shared with the
    scene it was given."""
    tris, tm, mats = (_dark_cornell() if name == "dark"
                      else SCENES[name][0]())
    emission = jspec.map_intensities(lambda i: i * 8.0,
                                     jspec.uniform_spectrum(1.0))
    np.testing.assert_array_equal(
        tspec.map_intensities(lambda i: i * 8.0, tspec.uniform_spectrum(1.0)),
        emission)
    pos = (0.0, 1.5, 0.3)
    js = jscene.add_point_light(jscene.build_scene(tris, tm, mats), pos,
                                emission)
    base = tscene.build_scene(tris, tm, mats, device="cpu")
    ts = tscene.add_point_light(base, pos, emission)
    assert ts.lights.count == base.lights.count + 1 == js.lights.count
    for f in ("kind", "tri", "theta", "emission"):
        got = getattr(ts.lights, f)
        assert got.dtype == getattr(base.lights, f).dtype
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js.lights, f)))
    np.testing.assert_array_equal(ts.light_table.numpy(),
                                  np.asarray(js.light_table))
    assert ts.light_table.shape == (ts.lights.count, 23)
    assert ts.accel is base.accel and ts.tris is base.tris
    assert ts.tri_mat is base.tri_mat and ts.mat_rows is base.mat_rows
    assert base.lights.count == (0 if name == "dark" else js.lights.count - 1)
    # a second light stacks on the first
    ts2 = tscene.add_point_light(ts, (0.5, 0.5, 0.0), emission)
    assert ts2.lights.count == ts.lights.count + 1
    np.testing.assert_array_equal(ts2.light_table[:-1].numpy(),
                                  ts.light_table.numpy())


def test_point_light_api():
    """The twin of the JAX package's test of the same name: a point light
    illuminates an otherwise dark box, through init -> sample_n_frames on
    the CPU, and the lit image agrees with the JAX package's in the mean."""
    import dataclasses
    tris, tm, mats = _dark_cornell()
    emission = tspec.map_intensities(lambda i: i * 8.0,
                                     tspec.uniform_spectrum(1.0))
    s = T.init(0, 12, 12, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8),
               device="cpu")
    dark = T.sample_n_frames(s, 16).numpy()
    s2 = dataclasses.replace(
        s, scene=tscene.add_point_light(s.scene, (0.0, 1.5, 0.3), emission))
    lit = T.sample_n_frames(s2, 16).numpy()
    assert dark.mean() < 1e-4
    assert lit.mean() > 0.01
    js = J.init(0, 12, 12, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))
    js2 = js.replace(scene=jscene.add_point_light(js.scene, (0.0, 1.5, 0.3),
                                                  emission))
    lit_j = np.asarray(J.sample_n_frames(js2, 16))
    px_ok = np.isclose(lit, lit_j, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert px_ok.mean() >= 0.97, np.argwhere(~px_ok)
    assert abs(lit.mean() - lit_j.mean()) <= 1e-2 * lit_j.mean()
