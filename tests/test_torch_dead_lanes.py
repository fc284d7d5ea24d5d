"""Dead lanes of the port's closest query (tracer_tpu_torch only, on the
CPU): a lane whose per-lane tmax is 0 or NaN misses, (+inf, 0), and every
other lane gets what the scalar tmax gives it, with and without a lane
permutation; path_trace, which hands its dead lanes over at tmax 0, gives
records, images, points and rays_traced identical to the loop that
re-traced every lane at F32_HIGHEST; and the launch operands carry the
heavy-first tile order for the closest query as for the any query. The
inputs are seeded with numpy; the JAX package has no such per-lane tmax,
so its parity with the port stays with tests/test_torch_integrator.py and
tests/test_torch_lidar.py."""

import numpy as np
import pytest
import torch

import tracer_tpu_torch as T
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.engine import shade
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import intersect
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.ops import shapes
from tracer_tpu_torch.ops import spectrum as spec
from tracer_tpu_torch.utils import kernel_cases as kc
from tracer_tpu_torch.utils import testscenes

torch.set_num_threads(2)

CAM = (0.0, 0.8, 1.8)


def _random_dense(n_tris, n_rays, pad_to=256):
    tris, o, d = kc.random_case(n_tris, n_rays)
    dense = intersect.build_dense(torch.as_tensor(tris), pad_to=pad_to)
    phi = intersect.ray_features_t(torch.as_tensor(o.T.copy()),
                                   torch.as_tensor(d.T.copy()))
    return dense, phi


def _mixed_tmax(n, seed):
    """Per-lane tmax: F32_HIGHEST (live), 0 (dead), NaN and 4.0, drawn
    from a seeded generator."""
    kind = np.random.default_rng(seed).integers(0, 4, n)
    t = np.select([kind == 0, kind == 1, kind == 2],
                  [shapes.F32_HIGHEST, 0.0, np.nan], 4.0)
    return torch.as_tensor(t.astype(np.float32)), kind


@pytest.mark.parametrize("perm", ["off", "oct", "odmorton"])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("n_tris", [100, 1100])
def test_closest_hit_per_lane_tmax(n_tris, stream, perm):
    """closest_hit_phi under a per-lane tmax with 0 and NaN lanes: those
    give (+inf, 0); the lanes at F32_HIGHEST and at 4 give what a scalar
    tmax gives them, whether or not the lanes are permuted (dead lanes
    first) before the wrapper sees them."""
    dense, phi = _random_dense(n_tris, 300)
    n = phi.shape[1]
    tmax, kind = _mixed_tmax(n, n_tris)
    bt, bi = intersect.closest_hit_phi(dense, tmax, phi, perm=perm,
                                       stream=stream)
    off = torch.as_tensor((kind == 1) | (kind == 2))
    assert off.any() and torch.isinf(bt[off]).all() and not bi[off].any()
    for value, sel in ((shapes.F32_HIGHEST, kind == 0), (4.0, kind == 3)):
        st, si = intersect.closest_hit_phi(dense, value, phi, perm="off",
                                           stream=stream)
        sel = torch.as_tensor(sel)
        assert torch.isfinite(st[sel]).any()
        assert torch.equal(bt[sel], st[sel]) and torch.equal(bi[sel], si[sel])
    # and through the V3 entry point: ok False, t +inf, index -1, aux 0
    o, d = phi[3:6], phi[0:3]
    ok, t, idx, _, _, aux = intersect.closest_hit(dense, tmax, o, d, perm=perm)
    assert not ok[off].any() and torch.isinf(t[off]).all()
    assert (idx[off] == -1).all() and not aux[off].any()


def test_lane_order_puts_dead_lanes_first(monkeypatch):
    """lane_order with dead_first and no spreading: every lane with
    tmax <= 0 comes before every live lane, each group in key order and,
    within a key, in lane order (a stable sort)."""
    monkeypatch.setattr(intersect, "SPREAD_WARPS", 0)
    dense, phi = _random_dense(1100, 300)
    n = phi.shape[1]
    tmax = torch.as_tensor(np.where(np.arange(n) % 3 == 0, 0.0, 1e30)
                           .astype(np.float32))
    cb = dense.chunk_bounds
    n_dead = int((tmax <= 0).sum())
    for mode in ("oct", "odmorton"):
        idx = intersect.lane_order(phi, tmax, cb, mode, dead_first=True)
        assert sorted(idx.tolist()) == list(range(n))
        assert (tmax[idx[:n_dead]] <= 0).all() and (tmax[idx[n_dead:]] > 0).all()
        key = intersect.perm_key(phi, cb, mode)[idx[n_dead:]]
        assert (key[1:] >= key[:-1]).all()
        same = key[1:] == key[:-1]
        assert (idx[n_dead:][1:][same] > idx[n_dead:][:-1][same]).all()
    # perm="auto" sorts a one-chunk query nowhere, and nothing on the CPU
    assert intersect.resolve_perm("auto", 1, "cuda") is None
    assert intersect.resolve_perm("auto", 16, "cuda") == "odmorton"
    assert intersect.resolve_perm("auto", 16, "cpu") is None


@pytest.mark.parametrize("n_live", [0, 3, 40, 100, 700, 1000])
def test_lane_order_spreads_few_live_lanes(n_live, monkeypatch):
    """lane_order with SPREAD_WARPS = W: a permutation in which the live
    lanes keep their key order; when they would fill fewer than W warps
    they sit k = ceil(L / W) to a warp from lane 0 on, each warp filled up
    with dead lanes while there are any; when they fill W warps or more
    (k = 32) the order is that of SPREAD_WARPS = 0; without dead_first
    nothing is spread."""
    n = 1000
    dense, phi = _random_dense(1100, n)
    cb = dense.chunk_bounds
    pick = np.random.default_rng(n_live).permutation(n)[:n_live]
    tmax = torch.zeros(n)
    tmax[torch.as_tensor(pick, dtype=torch.long)] = 4.0
    plain = intersect.lane_order(phi, tmax, cb, "odmorton")
    monkeypatch.setattr(intersect, "SPREAD_WARPS", 0)
    packed = intersect.lane_order(phi, tmax, cb, "odmorton", dead_first=True)
    for warps in (4, 8, 64):
        monkeypatch.setattr(intersect, "SPREAD_WARPS", warps)
        assert torch.equal(
            intersect.lane_order(phi, tmax, cb, "odmorton"), plain)
        idx = intersect.lane_order(phi, tmax, cb, "odmorton",
                                   dead_first=True)
        assert sorted(idx.tolist()) == list(range(n))
        live = tmax[idx] > 0
        assert torch.equal(idx[live], packed[n - n_live:])
        k = max(1, min(32, -(-n_live // warps)))
        if k == 32:
            assert torch.equal(idx, packed)
            continue
        per_warp = [int(live[i:i + 32].sum()) for i in range(0, n, 32)]
        full = min(n_live // k, (n - n_live) // (32 - k))
        assert per_warp[:full] == [k] * full
        assert all(live[i:i + k].all() for i in range(0, 32 * full, 32))


@pytest.mark.parametrize("name", ik.KERNELS)
def test_walk_operands_carry_the_tile_order(name):
    """walk_operands, the schedule part of a launch's arguments: (g,
    sbounds, order, count, tiles) built at the kernel's own block; K1-K4
    take tiles = heavy_first(count), the exact kernel none, and a
    one-chunk scene has neither a schedule nor an order."""
    dense, phi = _random_dense(1100, 700)
    tmax = torch.as_tensor(np.where(np.arange(700) % 4 == 0, 0.0, 4.0)
                           .astype(np.float32))
    cb = dense.chunk_bounds
    g, sb, order, count, tiles = ik.walk_operands(name, phi, tmax, cb)
    n_tiles = -(-700 // ik.BLOCKS[name])
    assert g == 1 and sb is cb
    assert order.shape == (n_tiles, 5) and count.shape == (n_tiles,)
    assert order.dtype == count.dtype == torch.int32
    if name == ik.EXACT:
        assert tiles is None
    else:
        assert tiles.dtype == torch.int32
        assert torch.equal(tiles, ik.heavy_first(count))
        assert sorted(tiles.tolist()) == list(range(n_tiles))
        assert (count[tiles.long()][1:] <= count[tiles.long()][:-1]).all()
    g3, sb3, order3, _, _ = ik.walk_operands(name, phi, tmax, cb, max_sched=3)
    assert g3 == 2 and sb3.shape == (3, 8) and order3.shape == (n_tiles, 3)
    one, phi1 = _random_dense(100, 50, pad_to=128)
    assert ik.walk_operands(name, phi1, 4.0, one.chunk_bounds)[2:] == (
        None, None, None)


def _path_trace_every_lane(state, scene, origin, d, wavelen, ambience,
                           trans=None):
    """path_trace as it was before dead lanes left the closest query:
    every lane, dead or alive, queries at F32_HIGHEST, so a dead lane
    re-traces its last ray."""
    n = d.shape[-1]
    dev = d.device
    ambient = spec.lookup_table(wavelen, ambience.to(dev))
    o = origin.expand(3, n)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    cum_dist = torch.zeros((n,), device=dev)
    dist = torch.full((tint.PATH_LEN, n), float("inf"), device=dev)
    rad = torch.zeros((tint.PATH_LEN, n), device=dev)
    rays = 0
    for i in range(tint.PATH_LEN):
        live = int(alive.sum())
        if live == 0:
            break
        inter = scene_mod.closest_interaction(
            scene, shapes.F32_HIGHEST, o, d, wavelen)
        prep = shade.prepare(state, alive, inter, d, wavelen, cum_dist,
                             scene.light_table, trans)
        sh = prep.shadow
        blocked = (scene_mod.any_hit(scene, sh.tmax, sh.origin, sh.dir)
                   if prep.n_lights else torch.zeros_like(sh.tmax, dtype=bool))
        rad[i] = shade.finish(blocked, prep, inter.emission_at_wl, ambient,
                              i == 0)
        state, cum_dist, dist[i] = prep.state, prep.cum_dist, prep.rec_dist
        alive_next, o_new, d_new = prep.scatters, prep.o, prep.d
        o = torch.where(alive_next, o_new, o)
        d = torch.where(alive_next, d_new, d)
        alive = alive_next
        rays += 3 * live
    return state, tint.PathRecords(distance=dist, radiance=rad), rays


SCENES = {"cornell": (testscenes.cornell_like, CAM),
          "prism": (testscenes.prism_scene, (0.0, 0.9, 2.6))}


@pytest.mark.parametrize("conf", [0, 2])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_path_trace_identical_without_dead_lanes(name, conf, monkeypatch):
    """sample_pixels and render_frames at 32x32, colour sensor and LiDAR:
    per-bounce records, rays_traced, the image and the point cloud equal,
    bit for bit, those of the loop that queried every lane at
    F32_HIGHEST; and the frame does have dead lanes."""
    scene_fn, origin = SCENES[name]
    s = T.init(0, 32, 32, conf, *scene_fn(), cam_origin=origin, device="cpu")
    args = (s.seed, s.nonce + 3, s.scene, s.cam, s.ambience, 32, 32,
            s.transmitter_kind)
    tmaxes = []
    orig = scene_mod.closest_interaction

    def spy(scene, tmax, *rest):
        tmaxes.append(tmax)
        return orig(scene, tmax, *rest)

    monkeypatch.setattr(scene_mod, "closest_interaction", spy)
    new = tint.sample_pixels(*args)
    new_out = tint.render_frames(*args, 2, s.render_mode, with_points=True)
    monkeypatch.setattr(scene_mod, "closest_interaction", orig)
    assert all(t.shape == (1024,) for t in tmaxes)
    assert (tmaxes[0] == shapes.F32_HIGHEST).all()
    assert any((t == 0).any() for t in tmaxes)
    assert all(((t == 0) | (t == shapes.F32_HIGHEST)).all() for t in tmaxes)

    monkeypatch.setattr(tint, "path_trace", _path_trace_every_lane)
    old = tint.sample_pixels(*args)
    old_out = tint.render_frames(*args, 2, s.render_mode, with_points=True)
    assert new.rays_traced == old.rays_traced > 1024
    assert torch.equal(new.path.distance, old.path.distance)
    assert torch.equal(new.path.radiance, old.path.radiance)
    assert torch.equal(new.ray_dir, old.ray_dir)
    assert new_out["rays_traced"] == old_out["rays_traced"]
    assert torch.equal(new_out["img"], old_out["img"])
    for a, b in zip(new_out["points"], old_out["points"]):
        assert torch.equal(a, b)
    assert float(new.path.radiance.sum()) > 0
