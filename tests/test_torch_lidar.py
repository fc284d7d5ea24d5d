"""Port parity: the LiDAR and flash sensors of tracer_tpu_torch (sensor
configs 1 and 2: the transmitter fan, its lights in direct lighting,
distance mode and the sample_points_n capture) against the JAX package
on the CPU, where the port runs the plain versions of its kernels.

Tolerances: geometry to rtol 1e-6; per-lane radiance as
tests/test_torch_direct.py and test_torch_integrator.py, on >= 99.5% of
lanes, since the 3-degree frustum's arccos test and near-specular lobes
flip a few lanes on an ulp; the capture as tests/test_engine.py holds the
pooled capture to the per-frame one, on >= 99% of pixels."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tracer_tpu as J
from tracer_tpu.engine import direct as jdirect, integrator as jint, keys
from tracer_tpu.models import camera as jcam, scene as jscene
from tracer_tpu.ops import materials as jmat, rng as jrng
from tracer_tpu.ops import shapes as jshapes
from tracer_tpu.utils import testscenes
from tracer_tpu.utils.image import write_png as jwrite_png
from tracer_tpu.utils.pcd import write_pcd as jwrite_pcd
import tracer_tpu_torch as T
from tracer_tpu_torch.engine import direct as tdirect, integrator as tint
from tracer_tpu_torch.frontends import save_demo
from tracer_tpu_torch.models import camera as tcam, scene as tscene
from tracer_tpu_torch.ops import materials as tmat, rng as trng
from tracer_tpu_torch.ops import shapes as tshapes
from tracer_tpu_torch.utils import convert
from tracer_tpu_torch.utils.image import write_png as twrite_png
from tracer_tpu_torch.utils.pcd import write_pcd as twrite_pcd

torch.set_num_threads(2)

ORIGIN = (0.0, 0.8, 1.8)
HIGHEST = 3.4028235e38


def _scene(dark=False):
    """cornell_like; dark: the ceiling light's emission killed, so the box
    has no emissive triangle (tests/test_engine.py:268-293)."""
    tris, tm, mats = testscenes.cornell_like()
    if dark:
        mats = mats.copy()
        mats[4, 16:28] = [-1, 0] * 6
    return tris, tm, mats


def _states(conf, size, dark=False):
    js = J.init(0, size, size, conf, *_scene(dark), cam_origin=ORIGIN)
    return js, convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close_share(t, j, rtol, atol, axis=0):
    """Share of lanes (along `axis`'s complement) where all agree."""
    ok = np.isclose(t, j, rtol=rtol, atol=atol, equal_nan=True)
    return ok.all(axis=axis) if axis is not None else ok


# ---------------------------------------------------------------------------
# the fan

def test_disk_sectors_v():
    r = np.random.default_rng(3)
    n = 64
    normal = r.normal(size=(3, n)).astype(np.float32)
    normal[:, :4] = [[0, 0, 0, 0], [1, -1, 2.5, -0.3], [0, 0, 0, 0]]  # || up
    normal /= np.linalg.norm(normal, axis=0)
    p = r.normal(size=(3, n)).astype(np.float32)
    radius = np.float32(0.05)
    js = jshapes.disk_sectors_v(jnp.asarray(p), jnp.asarray(normal),
                                jnp.float32(radius), 8)
    ts = tshapes.disk_sectors_v(_t(p), _t(normal), _t(radius), 8)
    assert len(ts) == len(js) == 8
    for jt, tt in zip(js, ts):
        for a, b in zip(jt, tt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    # the degenerate lanes took right = (1, 0, 0): b - p lies in the xz plane
    assert np.abs(ts[0][1].numpy()[1, :4] - p[1, :4]).max() < 1e-7


@pytest.mark.parametrize("conf", [1, 2])
def test_gen_transmitter_sectors(conf):
    js, ts = _states(conf, 8)
    d = np.random.default_rng(4).normal(size=(3, 32)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    jsec = jcam.gen_transmitter_sectors(js.cam, js.transmitter_kind,
                                        jnp.asarray(d))
    tsec = tcam.gen_transmitter_sectors(ts.cam, ts.transmitter_kind, _t(d))
    assert len(tsec) == tcam.TRANSMITTER_SECTORS == len(jsec)
    for jt, tt in zip(jsec, tsec):
        for a, b in zip(jt, tt):
            assert tuple(b.shape) == np.asarray(a).shape
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    assert tcam.gen_transmitter_sectors(ts.cam, "none", _t(d)) is None


# ---------------------------------------------------------------------------
# direct lighting with the transmitter

W = 32


def _lanes(js, ts):
    """Primary rays of a W x W grid in both packages from nonce 5."""
    n = W * W
    lane = np.arange(n)
    jx, iy = (lane % W).astype(np.float32), (W - lane // W - 1).astype(
        np.float32)
    jst = jrng.make_streams(js.seed, 5, jnp.arange(n, dtype=jnp.uint32))
    jst, jwl, _ = jcam.sample_wavelength(jst, js.cam.conf)
    jst, jo, jd = jcam.sample_ray(jst, js.cam, (jnp.float32(W), jnp.float32(W)),
                                  jnp.asarray(jx), jnp.asarray(iy))
    tst = trng.make_streams(ts.seed, 5, torch.arange(n))
    tst, twl, _ = tcam.sample_wavelength(tst, ts.cam.conf)
    tst, to, td = tcam.sample_ray(tst, ts.cam, (W, W), _t(jx), _t(iy))
    return (jst, jwl, jnp.broadcast_to(jo, (3, n)), jd), (tst, twl,
                                                          to.expand(3, n), td)


@pytest.mark.parametrize("dark", [False, True])
@pytest.mark.parametrize("conf", [1, 2])
def test_select_lane_light(conf, dark):
    js, ts = _states(conf, W, dark)
    assert (ts.scene.lights.count == 0) == dark
    (jst, jwl, _, jd), (tst, twl, _, td) = _lanes(js, ts)
    conf_j = js.cam.conf
    jsec = jcam.gen_transmitter_sectors(js.cam, js.transmitter_kind, jd)
    jst2, jl, jn = jdirect.select_lane_light(
        jst, js.scene, jsec, js.transmitter_kind, conf_j.trans_theta,
        conf_j.trans_emission, jwl, W * W)
    tst2, tl, tn = tdirect.select_lane_light(
        tst, ts.scene.light_table, twl,
        tdirect.transmitter(ts.cam, ts.transmitter_kind, td))
    assert tn == jn == ts.scene.lights.count + 8
    np.testing.assert_array_equal(tst2.numpy(),
                                  np.asarray(jst2).astype(np.int64))
    # the light index, bit for bit, from the same draw
    _, jli = jrng.select(jst, jn)
    _, tli = trng.select(tst, tn)
    np.testing.assert_array_equal(tli.numpy(), np.asarray(jli))
    assert (tli.numpy() >= tn - 8).any()
    assert dark or (tli.numpy() < tn - 8).any()
    np.testing.assert_array_equal(tl.kind.numpy(), np.asarray(jl.kind))
    for f in ("a", "b", "c", "theta", "em_val"):
        np.testing.assert_allclose(getattr(tl, f).numpy(),
                                   np.asarray(getattr(jl, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def _direct_pair(js, ts, bounce):
    (jst, jwl, jo, jd), (tst, twl, to, td) = _lanes(js, ts)
    conf_j = js.cam.conf
    jsec = jcam.gen_transmitter_sectors(js.cam, js.transmitter_kind, jd)
    trans = tdirect.transmitter(ts.cam, ts.transmitter_kind, td)
    ji = jscene.closest_interaction(js.scene, jnp.float32(HIGHEST), jo, jd, jwl)
    if bounce:
        jst, jwi, _, _, _ = jmat.sample_dir(jst, -jd, ji.normal, ji.mat)
        jo, jd = jshapes.mkray_adjust_acne_v(ji.pos, ji.normal, jwi)
        ji = jscene.closest_interaction(js.scene, jnp.float32(HIGHEST), jo,
                                        jd, jwl)
        ti = tscene.closest_interaction(ts.scene, tshapes.F32_HIGHEST, to,
                                        td, twl)
        tst, twi, _, _, _ = tmat.sample_dir(tst, -td, ti.normal, ti.mat)
        to, td = tshapes.mkray_adjust_acne_v(ti.pos, ti.normal, twi)
    jst, jrad = jdirect.direct_radiance(jst, js.scene, -jd, ji, jwl, jsec,
                                        js.transmitter_kind,
                                        conf_j.trans_theta,
                                        conf_j.trans_emission, mask=ji.ok)
    # the bounce's BSDF sample and roulette draw after NEE
    # (tracer_tpu/engine/integrator.py:111-118)
    jst, _, _, _, _ = jmat.sample_dir(jst, -jd, ji.normal, ji.mat)
    jst, _ = jrng.next_unit(jst)
    # the program's bounce (engine/shade.py's plain version on the CPU); no
    # emission, no ambient: the record of a hit is the direct light alone
    n = W * W
    b = tint._bounce(tst, ts.scene, torch.ones((n,), dtype=torch.bool), False,
                     to, td, twl, torch.zeros((n,)), torch.zeros((n,)), trans)
    return (jst, jrad, ji.ok), (b.state, b.radiance, b.hit)


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("conf", [1, 2])
def test_direct_radiance_with_transmitter(conf, bounce):
    js, ts = _states(conf, W)
    (jst, jrad, jhit), (tst, trad, thit) = _direct_pair(js, ts, bounce)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst).astype(np.int64))
    hit = thit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(jhit))
    # a lane whose bounce ray left the scene hits nothing: its record is 0
    assert (trad.numpy()[~hit] == 0).all()
    jrad, trad = np.asarray(jrad)[hit], trad.numpy()[hit]
    assert (jrad > 0).mean() > 0.1
    ok = _close_share(trad, jrad, 1e-4, 1e-5, axis=None)
    assert ok.mean() >= 0.995, (np.nonzero(~ok)[0][:10], trad[~ok][:10],
                                jrad[~ok][:10])


# ---------------------------------------------------------------------------
# the integrator

@pytest.mark.parametrize("conf", [1, 2])
def test_sample_pixels_lane_for_lane(conf):
    js, ts = _states(conf, 16)
    w, h = js.sub_dims
    jsam = jint.sample_pixels(js.seed, js.nonce + jnp.uint32(2), js.scene,
                              js.cam, js.ambience, w, h, js.transmitter_kind)
    tsam = tint.sample_pixels(ts.seed, ts.nonce + 2, ts.scene, ts.cam,
                              ts.ambience, w, h, ts.transmitter_kind)
    np.testing.assert_array_equal(tsam.channel.numpy(),
                                  np.asarray(jsam.channel))
    np.testing.assert_allclose(tsam.ray_dir.numpy(), np.asarray(jsam.ray_dir),
                               rtol=1e-5, atol=1e-6)
    jr, tr = np.asarray(jsam.path.radiance), tsam.path.radiance.numpy()
    assert (jr > 0).any(axis=0).mean() > 0.5
    assert _close_share(tr, jr, 1e-4, 1e-5).mean() >= 0.995
    jd, td = np.asarray(jsam.path.distance), tsam.path.distance.numpy()
    assert _close_share(td, jd, 1e-4, 1e-5).mean() >= 0.995
    assert abs(tsam.rays_traced - int(jsam.rays_traced)) <= 0.01 * int(
        jsam.rays_traced)
    # the distance image of the same records
    jimg = np.asarray(jint.visualize(jsam, "distance", None, w, h))
    timg = tint.visualize(tsam, "distance", None, w, h).numpy()
    assert _close_share(timg, jimg, 1e-4, 1e-5, axis=-1).mean() >= 0.99


def _records(seed, n=200):
    """Random per-bounce records with misses, dark bounces, records outside
    the window and exact-distance ties between bounces of one lane."""
    r = np.random.default_rng(seed)
    dist = r.uniform(0.0, 12.0, (16, n)).astype(np.float32)
    dist[r.random((16, n)) < 0.2] = np.inf
    rad = r.uniform(0.0, 2.0, (16, n)).astype(np.float32)
    rad[r.random((16, n)) < 0.3] = 0.0
    dist[:, :40] = np.inf                    # lanes 0-19: no return
    dist[1, 20:40] = dist[3, 20:40] = 1.5    # ties across bounces
    rad[1, 20:40], rad[3, 20:40] = 0.25, 0.75
    dist[5, 20:40] = 12.0                    # outside the window
    origin = r.normal(size=(3, n)).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return origin, d, dist, rad


def test_visualize_distance_and_closest_return():
    origin, d, dist, rad = _records(5)
    n = dist.shape[1]
    jsam = jint.FrameSamples(jnp.asarray(origin), jnp.asarray(d),
                             jnp.zeros(n, jnp.int32),
                             jint.PathRecords(jnp.asarray(dist),
                                              jnp.asarray(rad)), 0)
    tsam = tint.FrameSamples(_t(origin), _t(d), torch.zeros(n, dtype=torch.int32),
                             tint.PathRecords(_t(dist), _t(rad)), 0)
    np.testing.assert_allclose(tint.visualize_distance(tsam, n, 1).numpy(),
                               np.asarray(jint.visualize_distance(jsam, n, 1)),
                               rtol=1e-6, atol=1e-7)
    jcp = jint.to_cloud_points(jsam)
    tcp = tint.to_cloud_points(tsam)
    np.testing.assert_allclose(tcp.pos.numpy(), np.asarray(jcp.pos),
                               rtol=1e-6, atol=1e-6)
    jout = jint.closest_return(jcp, 1.0 / 8)
    tout = tint.closest_return(tcp, 1.0 / 8)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the tie within one sample goes to the first bounce, and a lane with
    # no return is (-1, -1, -1), +inf, 0
    np.testing.assert_array_equal(tout[2].numpy()[20:40], 0.25 / 8)
    np.testing.assert_array_equal(tout[0].numpy()[:, :20], -1.0)
    assert np.isinf(tout[1].numpy()[:20]).all()
    assert (tout[2].numpy()[:20] == 0).all()


def test_merge_returns_newer_sample_wins_a_tie():
    n = 5
    best = (torch.zeros((3, n)), torch.tensor([1.0, 2.0, 3.0, np.inf, 2.0]),
            torch.full((n,), 0.1))
    new = (torch.ones((3, n)), torch.tensor([1.0, 2.5, 2.0, np.inf, np.inf]),
           torch.full((n,), 0.2))
    pos, d, inten = tint.merge_returns(best, new)
    # tie -> new; larger -> old; smaller -> new; both none -> none; none new
    np.testing.assert_array_equal(inten.numpy(),
                                  np.float32([0.2, 0.1, 0.2, 0.1, 0.1]))
    np.testing.assert_array_equal(d.numpy(), [1.0, 2.0, 2.0, np.inf, 2.0])
    np.testing.assert_array_equal(pos[0].numpy(), [1, 0, 1, 0, 0])


_pooled = jax.jit(jint.render_pooled,
                  static_argnames=("w", "h", "transmitter_kind", "spp",
                                   "render_mode", "with_points"))


def test_render_frames_points_and_distance_match_pooled():
    """render_frames(with_points) against render_pooled(with_points) at
    16x16, 8 spp, config 2: the distance image and the closest returns."""
    js, ts = _states(2, 16)
    w, h = js.sub_dims
    spp = 8
    want = _pooled(js.seed, js.nonce, js.scene, js.cam, js.ambience, w=w,
                   h=h, transmitter_kind=js.transmitter_kind, spp=spp,
                   render_mode="distance", with_points=True)
    got = tint.render_frames(ts.seed, ts.nonce, ts.scene, ts.cam,
                             ts.ambience, w, h, ts.transmitter_kind, spp,
                             "distance", with_points=True)
    jimg, timg = np.asarray(want["img"]), got["img"].numpy()
    assert jimg.max() > 0.5
    assert _close_share(timg, jimg, 1e-4, 1e-5, axis=-1).mean() >= 0.99
    jpos, jd, ji = map(np.asarray, want["points"])
    tpos, td, ti = (x.numpy() for x in got["points"])
    jhas, thas = np.isfinite(jd), np.isfinite(td)
    assert jhas.mean() > 0.5 and abs(thas.mean() - jhas.mean()) <= 0.01
    ok = (np.isclose(td, jd, rtol=1e-4)
          & _close_share(tpos, jpos, 1e-3, 1e-4)
          & np.isclose(ti, ji, rtol=1e-3, atol=1e-6))
    assert ok.mean() >= 0.99, np.nonzero(~ok)[0]
    rays_j = int(want["rays_traced"])
    assert abs(got["rays_traced"] - rays_j) <= 1e-2 * rays_j


# ---------------------------------------------------------------------------
# the API

def test_sample_points_n_matches_jax():
    js, ts = _states(2, 16)
    js2, jpts = J.sample_points_n(js, 8)
    ts2, tpts = T.sample_points_n(ts, 8)
    jpts, tpts = np.asarray(jpts), tpts.numpy()
    assert tpts.shape == jpts.shape == (16, 16, 4)
    assert ts2.nonce == int(js2.nonce) == ts.nonce + 8
    jhas, thas = jpts[..., 3] > 0, tpts[..., 3] > 0
    assert abs(thas.mean() - jhas.mean()) <= 0.01
    ok = (_close_share(tpts[..., :3], jpts[..., :3], 1e-3, 1e-4, axis=-1)
          & np.isclose(tpts[..., 3], jpts[..., 3], rtol=1e-3, atol=1e-6))
    assert ok.mean() >= 0.99


def test_lidar_points_window():
    """Port twin of tests/test_engine.py:133-147."""
    _, s = _states(2, 16)
    s2, pts = T.sample_points_n(s, 8)
    pts = pts.numpy()
    assert pts.shape == (16, 16, 4)
    hit = pts[..., 3] > 0
    assert hit.any()
    dist = np.linalg.norm(pts[..., :3] - np.array(ORIGIN), axis=-1)
    assert (dist[hit] > 0.4).all() and (dist[hit] < 10.1).all()
    assert (pts[~hit] == [-1, -1, -1, 0]).all()
    assert s2.nonce == s.nonce + 8


def test_step_distance_mode_matches_jax():
    """Port twin of tests/test_engine.py:150-155, and step's distance
    merge (a pixel keeps its first return) against the JAX step."""
    js, ts = _states(2, 16)
    js = js.replace(mode=jnp.asarray(True))
    ts = T.key(keys.KEYDOWN, keys.SDLK_m, ts)
    for _ in range(3):
        js, ts = J.step(js), T.step(ts)
        jimg, timg = np.asarray(js.img), ts.img.numpy()
        assert np.isfinite(timg).all() and timg.min() >= 0
        assert timg.max() <= 1.0 + 1e-6
        assert _close_share(timg, jimg, 1e-4, 1e-5, axis=-1).mean() >= 0.99
    assert (ts.nonce, ts.n_frames) == (int(js.nonce), int(js.n_frames))


def test_flash_transmitter_adds_light():
    """Port twin of tests/test_engine.py:268-280."""
    tris, tm, mats = _scene(dark=True)
    dark = T.init(0, 16, 16, 0, tris, tm, mats, cam_origin=ORIGIN,
                  device="cpu")
    lit = T.init(0, 16, 16, 1, tris, tm, mats, cam_origin=ORIGIN,
                 device="cpu")
    img_dark = T.sample_n_frames(dark, 24).numpy()
    img_lit = T.sample_n_frames(lit, 24).numpy()
    assert img_dark.mean() < 1e-4
    assert img_lit.mean() > 10 * max(img_dark.mean(), 1e-6)


def test_scanning_transmitter_lights_lidar():
    """Port twin of tests/test_engine.py:283-292."""
    tris, tm, mats = _scene(dark=True)
    s = T.init(0, 16, 16, 2, tris, tm, mats, cam_origin=ORIGIN, device="cpu")
    _, pts = T.sample_points_n(s, 8)
    assert (pts[..., 3] > 0).float().mean() > 0.3


def test_state_from_numpy_config2():
    js = J.step(J.init(0, 8, 8, 2, *_scene(), cam_origin=ORIGIN))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert (ts.render_mode, ts.transmitter_kind, ts.cam_conf_id) == (
        "distance", "scanning", 2)
    assert ts.nonce == int(js.nonce) == 1
    np.testing.assert_array_equal(ts.img.numpy(), np.asarray(js.img))
    for f in ("trans_radius", "trans_theta", "trans_emission", "sensor_mu"):
        np.testing.assert_array_equal(getattr(ts.cam.conf, f).numpy(),
                                      np.asarray(getattr(js.cam.conf, f)))
    own = T.init(0, 8, 8, 2, *_scene(), cam_origin=ORIGIN, device="cpu")
    for a, b in zip(own.cam.conf, ts.cam.conf):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# output files and the frontend

def test_write_pcd_and_png_bytes_equal_jax(tmp_path):
    r = np.random.default_rng(0)
    pts = r.normal(size=(4, 5, 4)).astype(np.float32)
    pts[0, 0] = [-1, -1, -1, 0]
    jwrite_pcd(str(tmp_path / "j.pcd"), pts)
    twrite_pcd(str(tmp_path / "t.pcd"), pts)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    img = r.random((6, 7, 3)).astype(np.float32)
    jwrite_png(str(tmp_path / "j.png"), img)
    twrite_png(str(tmp_path / "t.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_save_demo_frontend_on_cpu(tmp_path, capsys):
    out = tmp_path / "cap.pcd"
    save_demo.main(["--device", "cpu", "-W", "8", "-H", "6", "-s", "2",
                    "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[9] == "POINTS 48" and len(lines) == 11 + 48
    assert "% returns" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    import inspect
    from tracer_tpu_torch.engine import api
    from tracer_tpu_torch.utils import measure_recip
    assert inspect.signature(api.init).parameters["device"].default == "cuda"
    assert inspect.signature(measure_recip.measure).parameters[
        "device"].default == "cuda"
    from tracer_tpu_torch.utils import checkpoint
    assert inspect.signature(checkpoint.load).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            save_demo.main(["-W", "4", "-H", "4", "-s", "1", "--out",
                            os.devnull])
