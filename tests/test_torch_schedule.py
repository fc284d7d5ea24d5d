"""Port parity: what the intersection kernels walk. The superchunk boxes
and the per-tile near-to-far chunk schedule of tracer_tpu_torch against
the JAX package's _superchunk_bounds and _tile_chunk_order; the
schedule's superset property on a 22-chunk scene, which makes every
scheduled walk exact; the boundary ray permutation's keys against the
JAX _perm_key, and permuted queries against unpermuted ones."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tracer_tpu_torch as T
from tracer_tpu.ops import intersect as jint
from tracer_tpu.ops.pallas import intersect_kernel as pk
from tracer_tpu_torch.ops import intersect as tint
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.ops import shapes
from tracer_tpu_torch.utils import kernel_cases as kc
from tracer_tpu_torch.utils import testscenes

torch.set_num_threads(2)

TILE = ik.BLOCK
# the tiles the kernels' schedules are built at (the blocks of K1-K4), and
# 128
TILES = sorted({*ik.BLOCKS.values(), 128})


def _chunks5():
    """1,100 random triangles in 5 chunks of 256, 300 random rays and the
    axis-parallel rays on every chunk's bound planes."""
    tris, o, d = kc.random_case(1100, 300)
    jd = jint.build_dense(jnp.asarray(tris))
    assert jd.chunk_bounds.shape[0] == 5
    po, pd = kc.on_plane_rays(np.asarray(jd.chunk_bounds))
    o, d = np.concatenate([o, po]), np.concatenate([d, pd])
    phi_j = jint.ray_features_t(jnp.asarray(o.T), jnp.asarray(d.T))
    return jd, phi_j, torch.as_tensor(np.array(phi_j))


def _jax_order(phi_j, tmax, sbounds_j, tile=TILE):
    """pk._tile_chunk_order on inputs padded as _pad_inputs pads them."""
    n = phi_j.shape[1]
    n_pad = -(-n // tile) * tile
    phi = jnp.pad(phi_j, ((0, 6), (0, n_pad - n)))
    tmv = jnp.pad(jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,)),
                  (0, n_pad - n))[None, :]
    order, count = pk._tile_chunk_order(phi, tmv, sbounds_j, n_pad // tile,
                                        tile)
    return np.asarray(order), np.asarray(count)


@pytest.mark.parametrize("g", [2, 3, 5])
def test_superchunk_bounds_matches_jax(g):
    jd, _, _ = _chunks5()
    got = ik.superchunk_bounds(torch.as_tensor(np.array(jd.chunk_bounds)), g)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pk._superchunk_bounds(jd.chunk_bounds, g)))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("tmax_kind", ["scalar", "per_lane"])
@pytest.mark.parametrize("max_sched", [64, 3])
def test_tile_chunk_order_matches_jax(max_sched, tmax_kind, tile):
    """g = 1 (5 chunks) and g = 2 (MAX_SCHED 3: 3 superchunks, the last
    one padded), at 256-lane tiles and at K2's narrower tile; count
    exactly, order exactly or where keys tie."""
    jd, phi_j, phi = _chunks5()
    n = phi.shape[1]
    tmax = (np.float32(1e30) if tmax_kind == "scalar" else
            np.where(np.arange(n) % 3 == 0, 0.0,
                     np.where(np.arange(n) % 3 == 1, 4.0, 1e30)
                     ).astype(np.float32))
    cb = torch.as_tensor(np.array(jd.chunk_bounds))
    g, sb, order, count = ik.walk_schedule(phi, torch.as_tensor(tmax), cb,
                                           max_sched, tile)
    assert g == (1 if max_sched == 64 else 2)
    assert order.shape[0] == -(-n // tile)
    sb_j = (jd.chunk_bounds if g == 1
            else pk._superchunk_bounds(jd.chunk_bounds, g))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(sb_j))
    order_j, count_j = _jax_order(phi_j, tmax, sb_j, tile)
    np.testing.assert_array_equal(count.numpy(), count_j)
    # the keys themselves, to excuse reorderings among equal entries
    n_pad = order.shape[0] * tile
    keys = ik._tile_entry(
        torch.nn.functional.pad(phi[:6], (0, n_pad - n)),
        torch.nn.functional.pad(torch.as_tensor(tmax).expand(n),
                                (0, n_pad - n)),
        sb, order.shape[0], tile).T.numpy()
    ot = order.numpy()
    for tile in range(ot.shape[0]):
        c = count_j[tile]
        kt = keys[tile, ot[tile, :c]]
        kj = keys[tile, order_j[tile, :c]]
        np.testing.assert_allclose(kt, kj, rtol=1e-6)
        assert set(ot[tile, :c]) == set(order_j[tile, :c])


def test_schedule_axis_parallel_ray_on_bound_plane():
    """An axis-parallel ray whose origin sits exactly on a chunk's bound
    plane (0 * inf = NaN in the slab test) keeps that chunk in its
    schedule (tests/test_pallas_kernel.py, same case)."""
    bounds = torch.tensor([[0.0, -1.0, -5.0, 1.0, 1.0, 5.0, 0.0, 0.0]])
    o = torch.tensor([[0.0], [0.0], [4.0]])
    d = torch.tensor([[0.0], [0.0], [-1.0]])
    phi = tint.ray_features_t(o, d)
    order, count = ik.tile_chunk_order(phi, 1e30, bounds)
    assert count.tolist() == [1] and order.tolist() == [[0]]
    _, count_j = _jax_order(jnp.asarray(phi.numpy()), 1e30,
                            jnp.asarray(bounds.numpy()))
    assert count_j.tolist() == [1]


def _sub4_state(size):
    tris, tm, mats = testscenes.cornell_like()
    tris, tm = testscenes.subdivide(tris, tm, levels=4)
    return T.init(0, size, size, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8),
                  device="cpu")


@pytest.mark.parametrize("max_sched", [64, 8])
def test_schedule_holds_every_winner(max_sched):
    """Superset property on subdivide(cornell_like, 4) (5,632 triangles,
    22 chunks; g = 1, and g = 3 at max_sched 8): for every lane of the
    camera and first-bounce rays, the chunk that holds the plain
    version's winner (its superchunk at g > 1) is in the lane's tile
    schedule order[tile, :count[tile]]."""
    s = _sub4_state(32)
    dense = s.scene.accel
    cb = dense.chunk_bounds
    assert cb.shape[0] == 22
    chunk_t = dense.coeffs.shape[1] // cb.shape[0]
    (o, d), (bo, bd), _ = kc.render_rays(s)
    for camera, (oo, dd) in ((True, (o, d)), (False, (bo, bd))):
        phi = tint.ray_features_t(oo, dd)
        bt, bi = ik.closest_hit_ref(dense.coeffs, phi, shapes.F32_HIGHEST, cb)
        g, _, order, count = ik.walk_schedule(phi, shapes.F32_HIGHEST, cb,
                                              max_sched)
        assert g == (1 if max_sched == 64 else 3)
        hit = torch.isfinite(bt)
        assert hit.float().mean() > 0.5
        lanes = torch.nonzero(hit)[:, 0]
        tile = lanes // TILE
        want = (bi[lanes].long() // chunk_t) // g
        ranks = torch.arange(order.shape[1])[None, :]
        listed = (order[tile].long() == want[:, None]) & (
            ranks < count[tile][:, None])
        assert bool(listed.any(dim=1).all())
        if camera:  # coherent rays: some tile leaves (super)chunks out
            assert int(count.min()) < order.shape[1]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("max_sched", [64, 8])
def test_warp_cull_model_reaches_every_winner(max_sched, tile):
    """kernel_cases.cull_pairs, the plain model of K2's warp-granular
    cull, on subdivide(cornell_like, 4) at 32x32 (camera and first-bounce
    rays): at tmax, the chunk that holds each lane's winner is reached by
    the lane's warp; the pairs at the final best t are a subset of those
    at tmax; and warps scan no more (lane, triangle) tests than blocks."""
    s = _sub4_state(32)
    dense = s.scene.accel
    cb = dense.chunk_bounds
    chunk_t = dense.coeffs.shape[1] // cb.shape[0]
    hi = torch.as_tensor(shapes.F32_HIGHEST, dtype=torch.float32)
    (o, d), (bo, bd), _ = kc.render_rays(s)
    for oo, dd in ((o, d), (bo, bd)):
        phi = tint.ray_features_t(oo, dd)
        bt, bi = ik.closest_hit_ref(dense.coeffs, phi, hi, cb)
        g, _, order, count = ik.walk_schedule(phi, hi, cb, max_sched, tile)
        top = hi.expand(bt.shape)
        most = kc.cull_pairs(phi, top, cb, g, order, count, tile)
        least = kc.cull_pairs(phi, torch.minimum(bt, hi), cb, g, order,
                              count, tile)
        blocks = kc.cull_pairs(phi, top, cb, g, order, count, tile,
                               group=tile)
        assert most.shape == (-(-phi.shape[1] // tile) * tile // 32,
                              cb.shape[0])
        lanes = torch.nonzero(torch.isfinite(bt))[:, 0]
        assert lanes.numel() > phi.shape[1] // 2
        assert bool(most[lanes // 32, bi[lanes].long() // chunk_t].all())
        assert bool((least <= most).all()) and int(least.sum()) > 0
        assert 32 * int(most.sum()) <= tile * int(blocks.sum())


def _shadow_case(max_sched, tile):
    """The 2N shadow lanes of subdivide(cornell_like, 4) at 32x32 (dead
    lanes among them), the plain version's hits, and the schedule at
    `tile` lanes."""
    s = _sub4_state(32)
    dense = s.scene.accel
    _, _, (so, sd, st) = kc.render_rays(s)
    phi = tint.ray_features_t(so, sd)
    occ = ik.any_hit_ref(dense.coeffs, phi, st, dense.chunk_bounds)
    assert 0 < int(occ.sum()) < int((st > 0).sum()) < st.shape[0]
    g, _, order, count = ik.walk_schedule(phi, st, dense.chunk_bounds,
                                          max_sched, tile)
    assert g == (1 if max_sched == 64 else 3)
    return dense, phi, st, occ, (g, order, count, tile)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("max_sched", [64, 8])
def test_any_hit_warp_cull_model_reaches_a_witness(max_sched, tile):
    """kernel_cases.cull_pairs as the plain model of the any-hit kernels'
    warp-granular cull: at tmax, the warp of every lane the plain version
    finds occluded reaches at least one chunk that holds a valid hit of
    that lane, so a walk that scans those pairs reports the lane."""
    dense, phi, st, occ, sched = _shadow_case(max_sched, tile)
    cb = dense.chunk_bounds
    chunk_t = dense.coeffs.shape[1] // cb.shape[0]
    most = kc.cull_pairs(phi, st, cb, *sched)
    valid = torch.stack([
        ik._chunk_scores(ik._chunk_rows(dense.coeffs, ci, chunk_t), phi, st,
                         chunk_t)[0].any(dim=0)
        for ci in range(cb.shape[0])])
    assert torch.equal(valid.any(dim=0), occ)
    lanes = torch.nonzero(occ)[:, 0]
    assert bool((most[lanes // 32] & valid[:, lanes].T).any(dim=1).all())


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("max_sched", [64, 8])
def test_any_hit_scan_bracket(max_sched, tile):
    """The bracket of the scans an any-hit kernel runs: the pairs of the
    lanes that never stop (kernel_cases.unstopped_bound: occluded and dead
    lanes get a NaN bound and pass nothing) are among the pairs at tmax,
    some warp of unstopped lanes is in both, and the dead lanes alone
    reach nothing."""
    dense, phi, st, occ, sched = _shadow_case(max_sched, tile)
    cb = dense.chunk_bounds
    keep = kc.unstopped_bound(st, occ)
    assert torch.equal(torch.isnan(keep), occ | (st <= 0))
    assert torch.equal(keep[~torch.isnan(keep)], st[~occ & (st > 0)])
    most = kc.cull_pairs(phi, st, cb, *sched)
    least = kc.cull_pairs(phi, keep, cb, *sched)
    assert bool((least <= most).all())
    assert 0 < int(least.sum()) <= int(most.sum())
    dead = kc.cull_pairs(phi, torch.where(st > 0, float("nan"), st), cb,
                         *sched)
    assert not bool(dead.any())


@pytest.mark.parametrize("tile", TILES)
def test_heavy_first_orders_tiles_by_schedule_length(tile):
    """heavy_first, the order in which the any-hit kernels work their
    tiles: a permutation of the tiles, counts never rising along it, equal
    counts in index order; tiles of dead lanes alone (no entries) last."""
    _, _, st, _, (_, order, count, _) = _shadow_case(64, tile)
    tiles = ik.heavy_first(count)
    assert tiles.dtype == torch.int32 and tiles.shape == count.shape
    assert sorted(tiles.tolist()) == list(range(count.shape[0]))
    along = count[tiles.long()]
    assert bool((along[1:] <= along[:-1]).all())
    same = along[1:] == along[:-1]
    assert bool((tiles[1:] > tiles[:-1])[same].all())
    assert int(along[0]) == int(count.max()) > int(along[-1])


@pytest.mark.parametrize("max_sched", [64, 3])
def test_block_cull_pairs_are_the_schedule_reach(max_sched):
    """At tmax and one group per tile, cull_pairs is the schedule's own
    reach: a (tile, chunk) pair passes exactly where some lane of the
    tile enters the chunk's box (a finite _tile_entry key) and its
    superchunk is scheduled; per-lane tmax with dead lanes and the
    on-plane rays of _chunks5."""
    jd, _, phi = _chunks5()
    n = phi.shape[1]
    tmax = torch.as_tensor(np.where(np.arange(n) % 3 == 0, 0.0, 4.0)
                           .astype(np.float32))
    cb = torch.as_tensor(np.array(jd.chunk_bounds))
    g, _, order, count = ik.walk_schedule(phi, tmax, cb, max_sched)
    got = kc.cull_pairs(phi, tmax, cb, g, order, count, TILE, group=TILE)
    n_pad = order.shape[0] * TILE
    keys = ik._tile_entry(
        torch.nn.functional.pad(phi[:6], (0, n_pad - n)),
        torch.nn.functional.pad(tmax, (0, n_pad - n)), cb, order.shape[0],
        TILE).T
    listed = torch.zeros_like(keys, dtype=torch.bool)
    for tile in range(order.shape[0]):
        for si in order[tile, :count[tile]].tolist():
            listed[tile, si * g:(si + 1) * g] = True
    assert torch.equal(got, torch.isfinite(keys) & listed)
    assert bool(got.any())


@pytest.mark.parametrize("mode", ["oct", "dmorton", "odmorton"])
def test_perm_key_matches_jax(mode):
    jd, phi_j, phi = _chunks5()
    want = np.asarray(jint._perm_key(phi_j, jd.chunk_bounds, mode))
    got = tint.perm_key(phi, torch.as_tensor(np.array(jd.chunk_bounds)), mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_perm_key_rejects_unknown_mode():
    _, _, phi = _chunks5()
    with pytest.raises(ValueError):
        tint.perm_key(phi, torch.zeros((1, 8)), "morton")


@pytest.mark.parametrize("mode", ["oct", "dmorton", "odmorton"])
def test_permuted_queries_match_unpermuted(mode):
    """Sorted lanes give every lane the result it gets unsorted: hits and
    best t equal, best_i equal outside ties; per-lane tmax with dead
    lanes for the shadow query."""
    s = _sub4_state(24)
    dense = s.scene.accel
    (o, d), (bo, bd), (so, sd, st) = kc.render_rays(s)
    phi = tint.ray_features_t(torch.cat([o, bo], 1), torch.cat([d, bd], 1))
    bt0, bi0 = tint.closest_hit_phi(dense, shapes.F32_HIGHEST, phi,
                                    perm="off")
    bt1, bi1 = tint.closest_hit_phi(dense, shapes.F32_HIGHEST, phi,
                                    perm=mode)
    assert torch.equal(bt0, bt1)
    _, tie = kc.boundary_lanes(dense.coeffs, phi, shapes.F32_HIGHEST,
                               dense.chunk_bounds)
    assert torch.equal(bi0[~tie], bi1[~tie])
    phi_s = tint.ray_features_t(so, sd)
    assert bool((st == 0).any())
    h0 = tint.any_hit_phi(dense, st, phi_s, perm="off")
    h1 = tint.any_hit_phi(dense, st, phi_s, perm=mode)
    assert torch.equal(h0, h1)
    assert not bool(h1[st == 0].any())


def test_perm_auto_sorts_only_on_the_card():
    """perm="auto" resolves to odmorton at the JAX package's thresholds on
    a CUDA device and never on the CPU; "off" never sorts."""
    assert tint.resolve_perm("auto", 22, "cuda") == "odmorton"
    assert tint.resolve_perm("auto", 15, "cuda") is None
    assert tint.resolve_perm("auto", 2, "cuda", any_hit=True) == "odmorton"
    assert tint.resolve_perm("auto", 1, "cuda", any_hit=True) is None
    assert tint.resolve_perm("auto", 5000, "cpu") is None
    assert tint.resolve_perm("auto", 5000, "cpu", any_hit=True) is None
    assert tint.resolve_perm("off", 5000, "cuda") is None
    assert tint.resolve_perm("dmorton", 1, "cpu") == "dmorton"
