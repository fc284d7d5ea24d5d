"""The plain reference against the port, lane for lane, at 8x8 on the
CPU: the per-sample records of one frame, and what each entry the
window drives returns (sample_n_frames, sample_points_n, step ->
render with accumulation on)."""

import numpy as np
import pytest
import torch

import tracer_tpu_torch as T
from portbench import check
from portbench.reference import estimator as E
from portbench.reference import scene as scene_mod
from tracer_tpu_torch.engine import integrator, keys
from tracer_tpu_torch.utils import image

W = H = 8
ORIGIN = (0.0, 0.8, 1.8)
SEED = 3_000_000_019        # above 2**31, as the benchmark's seeds are


@pytest.fixture(scope="module")
def box():
    return scene_mod.generate("cornell_like")


@pytest.fixture(scope="module")
def ref(box):
    return E.Scene(*box)


@pytest.mark.parametrize("conf", [0, 2])
def test_frame_records_lane_for_lane(box, ref, conf):
    s = T.init(SEED, H, W, conf, *box, cam_origin=ORIGIN, device="cpu")
    fs = integrator.sample_pixels(s.seed, 5, s.scene, s.cam, s.ambience, W,
                                  H, s.transmitter_kind)
    with np.errstate(all="ignore"):
        p = E.trace(ref, E.SENSORS[conf], ORIGIN, SEED, np.full(W * H, 5),
                    np.arange(W * H), W, H)
    assert (fs.channel.numpy() == p.channel).all()
    rad = fs.path.radiance.numpy()
    assert np.abs(rad - p.rad).max() <= 1e-5 * max(np.abs(p.rad).max(), 1)
    dist = fs.path.distance.numpy()
    assert (np.isfinite(dist) == np.isfinite(p.dist)).all()
    fin = np.isfinite(p.dist)
    assert np.allclose(dist[fin], p.dist[fin], rtol=1e-5)


def test_sample_n_frames(box, ref):
    s = T.init(SEED, H, W, 0, *box, cam_origin=ORIGIN, device="cpu")
    img = T.sample_n_frames(s, 7).numpy().reshape(-1, 3)
    with np.errstate(all="ignore"):
        want = E.render_pixels(ref, E.SENSORS[0], ORIGIN, SEED, 1, 6,
                               np.arange(W * H), W, H)
    assert check.pixel_gaps(img, want).max() < 1e-5
    assert img.mean() > 0.01


def test_sample_points_n(box, ref):
    s = T.init(SEED, H, W, 2, *box, cam_origin=ORIGIN, device="cpu")
    s, pts = T.sample_points_n(s, 3)
    s, pts = T.sample_points_n(s, 3)           # the second call: nonce 3
    with np.errstate(all="ignore"):
        want = E.capture_pixels(ref, E.SENSORS[2], ORIGIN, SEED, 3, 3,
                                np.arange(W * H), W, H)
    got = pts.numpy().reshape(-1, 4)
    assert (want[:, 3] > 0).mean() > 0.5
    gaps, one = check.point_gaps(got, want, ORIGIN)
    assert gaps.max() < 1e-5 and not one.any()


def test_viewer_accumulates_and_packs(box, ref):
    s = T.init(SEED, H, W, 0, *box, cam_origin=ORIGIN, device="cpu")
    s = T.key(keys.KEYDOWN, keys.SDLK_m, s)
    for _ in range(5):
        s = T.step(s)
        rgb = image.argb_to_rgb(T.render(s).numpy())
    with np.errstate(all="ignore"):
        img, packed = E.viewer_pixels(ref, E.SENSORS[0], ORIGIN, SEED, 5,
                                      np.arange(W * H), W, H)
    assert check.pixel_gaps(s.img.numpy().reshape(-1, 3), img).max() < 1e-5
    assert (rgb.reshape(-1, 3) == packed).mean() > 0.99


def test_brute_force_queries_match_the_scene(box):
    from portbench.reference.intersect import Triangles
    tris = Triangles(box[0], "cpu")
    o = np.tile(np.array([[0.5, 1.0, 0.9]], np.float32), (3, 1))
    d = np.array([[0, 0, -1], [0, 1, 0], [0, -1, 0]], np.float32)
    hit, t, ix = tris.closest(o, d, np.float32(1e30))
    assert hit.all()
    assert np.allclose(t, [1.9, 1.0, 1.0], rtol=1e-6)
    assert tris.any(o, d, np.array([1.8, 0.5, 1.5], np.float32)).tolist() \
        == [False, False, True]
    # the control rounds its operands: answers move, hits stay
    ctl = Triangles(box[0], "cpu", precision="tf32")
    _, t_c, _ = ctl.closest(o + np.float32(1e-3), d, np.float32(1e30))
    assert np.allclose(t_c, t, rtol=1e-2) and not np.array_equal(t_c, t)
