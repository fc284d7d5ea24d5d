"""Port parity: the wavefront integrator of tracer_tpu_torch against the
JAX package. sample_pixels is compared lane for lane; render_frames /
sample_n_frames against the JAX pooled renderer, which draws the same
per-(sample, pixel) streams. A rare Russian-roulette flip from 1-ulp
noise may move a lane (the JAX package sees the same between its own
graphs: integrator.py, RING WORK-STEALING note)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tracer_tpu as J
from tracer_tpu.engine import integrator as jint
from tracer_tpu.utils import testscenes
import tracer_tpu_torch as T
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.utils import convert

torch.set_num_threads(2)



def _cornell_sub4():
    """subdivide(cornell_like, 4): 5,632 triangles in 22 chunks, 512
    light triangles."""
    tris, tm, mats = testscenes.cornell_like()
    return (*testscenes.subdivide(tris, tm, levels=4), mats)


SCENES = {"cornell": (testscenes.cornell_like, (0.0, 0.8, 1.8)),
          "cornell_sub4": (_cornell_sub4, (0.0, 0.8, 1.8)),
          "prism": (testscenes.prism_scene, (0.0, 0.9, 2.6))}


def _states(name, size):
    scene_fn, origin = SCENES[name]
    js = J.init(0, size, size, 0, *scene_fn(), cam_origin=origin)
    return js, convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")


def test_sample_pixels_lane_for_lane():
    js, ts = _states("cornell", 16)
    w, h = js.sub_dims
    jsam = jint.sample_pixels(js.seed, js.nonce + jnp.uint32(2), js.scene,
                              js.cam, js.ambience, w, h, js.transmitter_kind)
    tsam = tint.sample_pixels(ts.seed, ts.nonce + 2, ts.scene, ts.cam,
                              ts.ambience, w, h, ts.transmitter_kind)
    np.testing.assert_array_equal(tsam.channel.numpy(), np.asarray(jsam.channel))
    np.testing.assert_allclose(tsam.ray_dir.numpy(), np.asarray(jsam.ray_dir),
                               rtol=1e-5, atol=1e-6)
    jr = np.asarray(jsam.path.radiance)
    tr = tsam.path.radiance.numpy()
    assert (jr > 0).any(axis=0).mean() > 0.5
    lane_ok = np.isclose(tr, jr, rtol=1e-4, atol=1e-5).all(axis=0)
    assert lane_ok.mean() >= 0.995, np.nonzero(~lane_ok)[0]
    jd = np.asarray(jsam.path.distance)
    td = tsam.path.distance.numpy()
    dist_ok = np.isclose(td, jd, rtol=1e-4, atol=1e-5).all(axis=0)
    assert dist_ok.mean() >= 0.995
    assert abs(tsam.rays_traced - int(jsam.rays_traced)) <= 0.01 * int(
        jsam.rays_traced)


_pooled = jax.jit(jint.render_pooled,
                  static_argnames=("w", "h", "transmitter_kind", "spp",
                                   "render_mode"))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sample_n_frames_matches_pooled(name):
    js, ts = _states(name, 16)
    w, h = js.sub_dims
    spp = 8
    # JAX sample_n_frames(s, spp + 1) is render_pooled from nonce + 1
    want = _pooled(js.seed, js.nonce + jnp.uint32(1), js.scene, js.cam,
                   js.ambience, w=w, h=h, transmitter_kind=js.transmitter_kind,
                   spp=spp, render_mode=js.render_mode)
    img_j = np.asarray(want["img"])
    img_t = T.sample_n_frames(ts, spp + 1).numpy()
    out = tint.render_frames(ts.seed, ts.nonce + 1, ts.scene, ts.cam,
                             ts.ambience, w, h, ts.transmitter_kind, spp,
                             ts.render_mode)
    np.testing.assert_array_equal(out["img"].numpy(), img_t)
    assert img_j.max() > 0.5
    px_ok = np.isclose(img_t, img_j, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert px_ok.mean() >= 0.99, np.argwhere(~px_ok)
    assert abs(img_t.mean() - img_j.mean()) <= 1e-3 * img_j.mean()
    # rays_traced: 3 x live lanes per bounce, primaries not counted, as
    # render_pooled counts them
    rays_j = int(want["rays_traced"])
    assert abs(out["rays_traced"] - rays_j) <= 1e-3 * rays_j


NOT_PORTED = r"sensor configs 1 and 2.*\(ROADMAP\.md, Queue 1\)"


def test_not_ported_paths_raise():
    js, ts = _states("cornell", 8)
    with pytest.raises(NotImplementedError, match=NOT_PORTED):
        tint.render_frames(ts.seed, 0, ts.scene, ts.cam, ts.ambience, 8, 8,
                           "flash", 1, "color")
    with pytest.raises(NotImplementedError, match=NOT_PORTED):
        tint.render_frames(ts.seed, 0, ts.scene, ts.cam, ts.ambience, 8, 8,
                           "none", 1, "distance")
    with pytest.raises(NotImplementedError,
                       match=r"sample_points_n .*LiDAR point cloud "
                             r"\(ROADMAP\.md, Queue 1\)"):
        T.sample_points_n(ts, 2)
    lbvh = J.init(0, 8, 8, 0, *testscenes.cornell_like(),
                  cam_origin=(0.0, 0.8, 1.8), accel="lbvh")
    with pytest.raises(NotImplementedError,
                       match=r"LBVH accel .*\(ROADMAP\.md, Queue 1\)"):
        convert.state_from_numpy(jax.tree.map(np.asarray, lbvh), "cpu")


def test_hue_and_accumulate():
    hue = np.linspace(0.0, 0.999, 257).astype(np.float32)
    np.testing.assert_allclose(tint.hue_to_rgb(torch.as_tensor(hue)).numpy(),
                               np.asarray(jint.hue_to_rgb(jnp.asarray(hue))),
                               rtol=1e-6, atol=1e-6)
    r = np.random.default_rng(0)
    acc, new = (r.random((4, 5, 3)).astype(np.float32) for _ in range(2))
    acc[0] = 0.0
    for nf in (1, 2, 7):
        np.testing.assert_allclose(
            tint.accumulate_color(torch.as_tensor(acc), torch.as_tensor(new),
                                  nf).numpy(),
            np.asarray(jint.accumulate_color(acc, new, jnp.uint32(nf))),
            rtol=1e-6)
    np.testing.assert_array_equal(
        tint.accumulate_distance(torch.as_tensor(acc),
                                 torch.as_tensor(new)).numpy(),
        np.asarray(jint.accumulate_distance(acc, new)))
