"""Port parity: render_pooled of tracer_tpu_torch, the pool of lanes in
which a lane whose path has ended takes the next (sample, pixel) work
item, against the port's render_frames (spp whole wavefronts) and the
JAX render_pooled, which draw the same per-(sample, pixel) streams.

Against render_frames the pool is held exactly in rays_traced, distance
image and points: on the CPU a lane's hit does not depend on where the
lane sits in the batch. Against JAX a rare Russian-roulette flip from
1-ulp noise may move a pixel, as between the JAX package's own graphs."""

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
from tracer_tpu_torch.ops import rng as trng
from tracer_tpu_torch.utils import convert

torch.set_num_threads(2)

W, H = 16, 12
ODD_POOL = 100   # divides neither W * H nor W * H * spp for spp 1, 3, 8
NONCE = 5

_jpooled = jax.jit(jint.render_pooled,
                   static_argnames=("w", "h", "transmitter_kind", "spp",
                                    "render_mode", "with_points"))


def _state(conf):
    return T.init(0, H, W, conf, *testscenes.cornell_like(),
                  cam_origin=(0.0, 0.8, 1.8), device="cpu")


def _args(s, nonce=NONCE):
    return (s.seed, nonce, s.scene, s.cam, s.ambience, W, H,
            s.transmitter_kind)


def _fix_pool(monkeypatch, pool):
    if pool is not None:
        monkeypatch.setattr(tint, "_pool_size", lambda n, spp, t_pad: pool)


def _assert_same(a, b):
    """The pool's result a against b: distance image and points equal
    exactly, a colour image within rtol 1e-5 (summation order)."""
    assert a["rays_traced"] == b["rays_traced"]
    assert a["img"].shape == b["img"].shape == (H, W, 3)
    np.testing.assert_allclose(a["img"].numpy(), b["img"].numpy(),
                               rtol=1e-5, atol=0)
    for x, y in zip(a.get("points", ()), b.get("points", ())):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("pool", [None, ODD_POOL])
@pytest.mark.parametrize("spp", [1, 3, 8])
@pytest.mark.parametrize("conf", [0, 1, 2])
def test_pool_equals_render_frames(conf, spp, pool, monkeypatch):
    s = _state(conf)
    want = tint.render_frames(*_args(s), spp, s.render_mode, with_points=True)
    _fix_pool(monkeypatch, pool)
    got = tint.render_pooled(*_args(s), spp, s.render_mode, with_points=True)
    _assert_same(got, want)
    if s.render_mode == "distance":
        np.testing.assert_array_equal(got["img"].numpy(), want["img"].numpy())
        assert torch.isfinite(got["points"][1]).float().mean() > 0.5
    else:
        assert got["img"].max() > 0.5
    # iterations: at least the items over the lanes, at most the frames'
    p = pool or tint._pool_size(W * H, spp, 128)
    assert got["iters"] >= -(-W * H * spp // p)
    assert got["iters"] <= -(-W * H * spp // p) * tint.PATH_LEN
    assert got["rays_traced"] <= 3 * p * got["iters"]


@pytest.mark.parametrize("conf", [0, 1, 2])
def test_pool_without_points(conf, monkeypatch):
    s = _state(conf)
    _fix_pool(monkeypatch, ODD_POOL)
    with_p = tint.render_pooled(*_args(s), 3, s.render_mode, with_points=True)
    without = tint.render_pooled(*_args(s), 3, s.render_mode)
    assert sorted(without) == ["img", "iters", "lanes", "rays_traced"]
    assert with_p["lanes"] == without["lanes"] == ODD_POOL
    assert torch.equal(with_p["img"], without["img"])
    assert with_p["rays_traced"] == without["rays_traced"]
    assert with_p["iters"] == without["iters"]
    want = tint.render_frames(*_args(s), 3, s.render_mode)
    _assert_same(without, want)


@pytest.mark.parametrize("conf", [0, 1, 2])
def test_pool_matches_jax_pool(conf, monkeypatch):
    js = J.init(0, H, W, conf, *testscenes.cornell_like(),
                cam_origin=(0.0, 0.8, 1.8))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    spp = 3
    want = _jpooled(js.seed, js.nonce + jnp.uint32(NONCE), js.scene, js.cam,
                    js.ambience, w=W, h=H,
                    transmitter_kind=js.transmitter_kind, spp=spp,
                    render_mode=js.render_mode, with_points=True)
    _fix_pool(monkeypatch, ODD_POOL)
    got = tint.render_pooled(*_args(ts), spp, ts.render_mode,
                             with_points=True)
    rays_j = int(want["rays_traced"])
    assert abs(got["rays_traced"] - rays_j) <= 1e-3 * rays_j
    img_j = np.asarray(want["img"])
    assert img_j.max() > 0.5
    px_ok = np.isclose(got["img"].numpy(), img_j, rtol=1e-4,
                       atol=1e-5).all(axis=-1)
    assert px_ok.mean() >= 0.99, np.argwhere(~px_ok)
    pos_j, d_j, i_j = (np.asarray(x) for x in want["points"])
    pos_t, d_t, i_t = (x.numpy() for x in got["points"])
    has = np.isfinite(d_j)
    assert has.mean() > 0.5
    lane_ok = ((np.isfinite(d_t) == has)
               & np.isclose(np.where(has, d_t, 0), np.where(has, d_j, 0),
                            rtol=1e-4, atol=1e-5)
               & np.isclose(pos_t, pos_j, rtol=1e-4, atol=1e-4).all(axis=0)
               & np.isclose(i_t, i_j, rtol=1e-4, atol=1e-6))
    assert lane_ok.mean() >= 0.99, np.nonzero(~lane_ok)[0]


@pytest.mark.parametrize("conf", [0, 2])
def test_tile_equals_rows_of_full_render(conf, monkeypatch):
    """(row0, full_h): rows 4..9 of the frame, bit for bit."""
    s = _state(conf)
    _fix_pool(monkeypatch, ODD_POOL)
    full = tint.render_pooled(*_args(s), 3, s.render_mode, with_points=True)
    row0, th = 4, 5
    tile = tint.render_pooled(s.seed, NONCE, s.scene, s.cam, s.ambience, W,
                              th, s.transmitter_kind, 3, s.render_mode,
                              row0=row0, full_h=H, with_points=True)
    assert tile["img"].shape == (th, W, 3)
    assert torch.equal(tile["img"], full["img"][row0:row0 + th])
    lanes = slice(row0 * W, (row0 + th) * W)
    for x, y in zip(tile["points"], full["points"]):
        assert torch.equal(x, y[..., lanes])
    assert 0 < tile["rays_traced"] < full["rays_traced"]


@pytest.mark.parametrize("conf", [0, 2])
def test_two_calls_equal_bit_for_bit(conf):
    s = _state(conf)
    a = tint.render_pooled(*_args(s), 3, s.render_mode, with_points=True)
    b = tint.render_pooled(*_args(s), 3, s.render_mode, with_points=True)
    assert torch.equal(a["img"], b["img"])
    assert all(torch.equal(x, y) for x, y in zip(a["points"], b["points"]))
    assert (a["rays_traced"], a["iters"]) == (b["rays_traced"], b["iters"])
    c = tint.render_pooled(*_args(s, NONCE + 1), 3, s.render_mode)
    assert not torch.equal(a["img"], c["img"])


@pytest.mark.parametrize("store_bytes", [1, 2 * W * H * 25])
def test_rounds_of_samples_merge_in_sample_order(store_bytes, monkeypatch):
    """A render whose slots outgrow STORE_BYTES runs in rounds of whole
    samples (here 1 and 2 at a time) and gives the same result."""
    s = _state(2)
    want = tint.render_pooled(*_args(s), 5, s.render_mode, with_points=True)
    s0 = _state(0)
    want0 = tint.render_pooled(*_args(s0), 5, s0.render_mode)
    monkeypatch.setattr(tint, "STORE_BYTES", store_bytes)
    got = tint.render_pooled(*_args(s), 5, s.render_mode, with_points=True)
    assert torch.equal(got["img"], want["img"])
    assert all(torch.equal(x, y) for x, y in zip(got["points"],
                                                 want["points"]))
    assert got["rays_traced"] == want["rays_traced"]
    got0 = tint.render_pooled(*_args(s0), 5, s0.render_mode)
    assert torch.equal(got0["img"], want0["img"])


@pytest.mark.parametrize("nonce", [0, 7, 0xFFFFFFFE])
def test_per_lane_stream_equals_make_streams(nonce):
    """make_streams_per_lane(seed, nonce + s, pix) is make_streams(seed,
    nonce + s, pix) for every s, nonce + s wrapped to 32 bits."""
    seed = 0xDEADBEEF
    pix = torch.arange(0, 300, dtype=torch.int64) * 7919
    for s in range(5):
        frame = (nonce + s) & trng.MASK
        want = trng.make_streams(seed, frame, pix)
        got = trng.make_streams_per_lane(
            seed, trng.as_u32(nonce + torch.full_like(pix, s)), pix)
        assert torch.equal(got, want)
    s_mixed = pix % 5
    got = trng.make_streams_per_lane(seed, trng.as_u32(nonce + s_mixed), pix)
    for s in range(5):
        want = trng.make_streams(seed, (nonce + s) & trng.MASK, pix)
        assert torch.equal(got[s_mixed == s], want[s_mixed == s])
    assert int(got.min()) >= 0 and int(got.max()) <= trng.MASK


def test_points_tie_goes_to_larger_s(monkeypatch):
    """Without jitter and lens every sample of a pixel sends the same
    primary ray, so the first-bounce distances tie exactly across the
    samples; the point kept is that of the LARGEST s among them."""
    s = _state(2)
    conf = s.cam.conf._replace(offset_radius=torch.tensor(0.0),
                               aperture=torch.tensor(0.0))
    cam = s.cam._replace(conf=conf)
    spp = 4
    per_s = [tint.closest_return(tint.to_cloud_points(tint.sample_pixels(
        s.seed, NONCE + k, s.scene, cam, s.ambience, W, H,
        s.transmitter_kind)), 1.0 / spp) for k in range(spp)]
    dist = torch.stack([p[1] for p in per_s])
    inten = torch.stack([p[2] for p in per_s])
    best = dist.amin(dim=0)
    tied = (dist == best) & torch.isfinite(best)
    assert (tied.sum(dim=0) >= 2).float().mean() > 0.3   # real ties
    last = (spp - 1) - tied.flip(0).to(torch.uint8).argmax(dim=0)
    first = tied.to(torch.uint8).argmax(dim=0)
    want_i = torch.gather(inten, 0, last[None])[0]
    first_i = torch.gather(inten, 0, first[None])[0]
    has = torch.isfinite(best)
    assert ((want_i != first_i) & has).any()   # the rule is observable
    _fix_pool(monkeypatch, ODD_POOL)
    got = tint.render_pooled(s.seed, NONCE, s.scene, cam, s.ambience, W, H,
                             s.transmitter_kind, spp, s.render_mode,
                             with_points=True)
    assert torch.equal(got["points"][1], best)
    assert torch.equal(got["points"][2][has], want_i[has])


def test_api_runs_the_pool(monkeypatch):
    """step, step_render, sample_n_frames and sample_points_n go through
    render_pooled; nothing on the API path calls render_frames."""
    def refuse(*a, **k):
        raise AssertionError("render_frames called from the API")
    calls = []
    pooled = tint.render_pooled

    def counted(*a, **k):
        calls.append(a[8])
        return pooled(*a, **k)
    monkeypatch.setattr(tint, "render_frames", refuse)
    monkeypatch.setattr(tint, "render_pooled", counted)
    s = _state(2)
    s1 = T.step(s)
    s2, argb = T.step_render(s1)
    img = T.sample_n_frames(s2, 4)
    s3, pts = T.sample_points_n(s2, 3)
    assert calls == [1, 1, 3, 3]
    assert (s1.nonce, s2.nonce, s3.nonce) == (1, 2, 5)
    assert argb.shape == (H, W) and img.shape == (H, W, 3)
    assert pts.shape == (H, W, 4)


@pytest.mark.parametrize("n,spp,t_pad", [(16, 1, 128), (480000, 1, 128),
                                         (262144, 16, 128),
                                         (262144, 16, 90112),
                                         (307200, 100, 128)])
def test_pool_size_bounds(n, spp, t_pad):
    p = tint._pool_size(n, spp, t_pad)
    assert 1 <= p <= n * spp
    assert p == n * spp or p >= 65536


def test_pool_refuses_bad_arguments():
    s = _state(0)
    with pytest.raises(ValueError, match="spp"):
        tint.render_pooled(*_args(s), 0, "color")
    with pytest.raises(ValueError, match="render_mode"):
        tint.render_pooled(*_args(s), 1, "depth")
    with pytest.raises(ValueError, match="transmitter_kind"):
        tint.render_pooled(s.seed, 0, s.scene, s.cam, s.ambience, W, H,
                           "laser", 1, "color")
