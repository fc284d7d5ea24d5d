"""Port parity: NEE+MIS direct lighting of tracer_tpu_torch (the bounce's
shading, engine/shade.py, whose CPU version is the plain one) against the
JAX package's direct_radiance, lane for lane, at the first hit of camera
rays and at one bounce further."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tracer_tpu as J
from tracer_tpu.engine import direct as jdirect
from tracer_tpu.models import camera as jcam, scene as jscene
from tracer_tpu.ops import materials as jmat, rng as jrng, shapes as jshapes
from tracer_tpu.utils import testscenes
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.models import camera as tcam, scene as tscene
from tracer_tpu_torch.ops import materials as tmat, rng as trng
from tracer_tpu_torch.ops import shapes as tshapes
from tracer_tpu_torch.utils import convert

torch.set_num_threads(2)

SCENES = {"cornell": (testscenes.cornell_like, (0.0, 0.8, 1.8)),
          "prism": (testscenes.prism_scene, (0.0, 0.9, 2.6))}
W = 32
HIGHEST = 3.4028235e38


def _jax_side(js, n, lane, bounce):
    st = jrng.make_streams(js.seed, 5, jnp.arange(n, dtype=jnp.uint32))
    st, wl, _ = jcam.sample_wavelength(st, js.cam.conf)
    st, o, d = jcam.sample_ray(st, js.cam, (jnp.float32(W), jnp.float32(W)),
                               jnp.asarray(lane % W, jnp.float32),
                               jnp.asarray(W - lane // W - 1, jnp.float32))
    o = jnp.broadcast_to(o, (3, n))
    inter = jscene.closest_interaction(js.scene, jnp.float32(HIGHEST), o, d, wl)
    if bounce:
        st, wi, _, _, _ = jmat.sample_dir(st, -d, inter.normal, inter.mat)
        o, d = jshapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi)
        inter = jscene.closest_interaction(js.scene, jnp.float32(HIGHEST), o,
                                           d, wl)
    conf = js.cam.conf
    st, rad = jdirect.direct_radiance(st, js.scene, -d, inter, wl, None,
                                      "none", conf.trans_theta,
                                      conf.trans_emission, mask=inter.ok)
    # the bounce's BSDF sample and roulette draw after NEE
    # (tracer_tpu/engine/integrator.py:111-118)
    st, _, _, _, _ = jmat.sample_dir(st, -d, inter.normal, inter.mat)
    st, _ = jrng.next_unit(st)
    return st, rad, inter.ok


def _torch_side(ts, n, lane, bounce):
    st = trng.make_streams(ts.seed, 5, torch.arange(n))
    st, wl, _ = tcam.sample_wavelength(st, ts.cam.conf)
    st, o, d = tcam.sample_ray(st, ts.cam, (W, W),
                               torch.as_tensor(lane % W, dtype=torch.float32),
                               torch.as_tensor(W - lane // W - 1,
                                               dtype=torch.float32))
    o = o.expand(3, n)
    if bounce:
        inter = tscene.closest_interaction(ts.scene, tshapes.F32_HIGHEST, o,
                                           d, wl)
        st, wi, _, _, _ = tmat.sample_dir(st, -d, inter.normal, inter.mat)
        o, d = tshapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi)
    # the program's bounce: closest hit, NEE + MIS (engine/shade.py's plain
    # version on the CPU), the BSDF step; no emission, no ambient, so the
    # record of a hit is the direct light alone
    b = tint._bounce(st, ts.scene, torch.ones((n,), dtype=torch.bool), False,
                     o, d, wl, torch.zeros((n,)), torch.zeros((n,)), None)
    return b.state, b.radiance, b.hit


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_direct_radiance_lane_for_lane(name, bounce):
    scene_fn, origin = SCENES[name]
    js = J.init(0, W, W, 0, *scene_fn(), cam_origin=origin)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    n = W * W
    lane = np.arange(n)
    jst, jrad, jhit = _jax_side(js, n, lane, bounce)
    tst, trad, thit = _torch_side(ts, n, lane, bounce)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst).astype(np.int64))
    hit = thit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(jhit))
    jrad = np.asarray(jrad)[hit]
    assert (jrad > 0).mean() > 0.1
    # a lane whose bounce ray left the scene hits nothing: its record is 0
    assert (trad.numpy()[~hit] == 0).all()
    trad = trad.numpy()[hit]
    close = np.isclose(trad, jrad, rtol=1e-4, atol=1e-5)
    assert close.all(), (np.nonzero(~close)[0][:10], trad[~close][:10],
                         jrad[~close][:10])


def test_area_incident_radiance():
    from tracer_tpu.models import lights as jlights
    from tracer_tpu_torch.models import lights as tlights
    r = np.random.default_rng(9)
    n = 1024
    kind = np.where(np.arange(n) % 2 == 0, tlights.KIND_DIFFUSE_AREA,
                    tlights.KIND_FRUSTUM_AREA).astype(np.int32)
    tri = r.normal(size=(n, 3, 3)).astype(np.float32)
    theta = r.uniform(0.1, 1.5, n).astype(np.float32)
    emission = r.uniform(300, 800, (n, 6, 2)).astype(np.float32)
    emission[:, 4:, 0] = -1.0
    hitp = r.normal(size=(n, 3)).astype(np.float32)
    lightp = tri.mean(axis=1)
    wl = r.uniform(380, 720, n).astype(np.float32)
    args = (kind, tri, theta, emission, hitp, lightp, wl)
    j = np.asarray(jlights.area_incident_radiance(*map(jnp.asarray, args)))
    t = tlights.area_incident_radiance(*map(torch.as_tensor, args)).numpy()
    assert (j > 0).mean() > 0.2
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
