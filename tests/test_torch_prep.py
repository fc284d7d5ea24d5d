"""The preparation of a sorted query (tracer_tpu_torch only): the custom
ops tracer_tpu_torch::lane_key and lane_deal, whose CPU implementation is
the plain version (ops/intersect.py perm_key and lane_order) and whose
CUDA one is csrc/prep.cu's key and deal kernels, and walk_operands, whose
schedule and tile order csrc/prep.cu's kernels build on the card.

On the CPU: the ops against the plain functions, the closed form of the
deal that the deal kernel computes against lane_order, the fake rules and
the counts. On the card (requires_cuda): each kernel bit for bit against
its plain version run on the card (every key, dead-first on and off, few
and no dead lanes, tiles of 64, 128 and 256 over ragged lane counts,
S = 2..64 and padded superchunks, axis-parallel rays on box planes, scalar
and per-lane tmax, the pool's operands on SPD tetra at size factors 4 and
8), and the queries' answers against those of the plain preparation."""

import numpy as np
import pytest
import torch

import tracer_tpu_torch as T
from portbench.scenes import spd_tetra
from tracer_tpu_torch.ops import cuda_lib, intersect
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.utils import kernel_cases as kc
from tracer_tpu_torch.utils import profiling

torch.set_num_threads(2)

# live lanes of the deal's cases, of N = 1000 (1000: no dead lane)
LIVE = (0, 1, 37, 250, 999, 1000)
SPREADS = (1, 3, 8, 64)


def _dense_rays(n_tris, n_rays, device="cpu", seed=7):
    """build_dense of kc.random_case's triangles, its rays with the
    axis-parallel rays on every chunk's bound planes among them (so
    direction components of 0 and origins on box planes), and a mixed
    per-lane tmax: 1e30, 4, 0 and NaN."""
    tris, o, d = kc.random_case(n_tris, n_rays)
    dense = intersect.build_dense(torch.as_tensor(tris, device=device))
    po, pd = kc.on_plane_rays(dense.chunk_bounds.cpu().numpy())
    o, d = np.concatenate([o, po]), np.concatenate([d, pd])
    phi = intersect.ray_features_t(torch.as_tensor(o.T.copy(), device=device),
                                   torch.as_tensor(d.T.copy(), device=device))
    kind = np.random.default_rng(seed).integers(0, 4, phi.shape[1])
    tmax = np.select([kind == 0, kind == 1, kind == 2], [1e30, 4.0, 0.0],
                     np.nan).astype(np.float32)
    return dense, phi, torch.as_tensor(tmax, device=device)


def _live_tmax(n, n_live, device="cpu"):
    tmax = torch.zeros(n, device=device)
    pick = np.random.default_rng(n_live).permutation(n)[:n_live]
    tmax[torch.as_tensor(pick, dtype=torch.long, device=device)] = 4.0
    return tmax


def _dealt(n, n_dead, spread):
    """The deal kernel's closed form: where sorted position p (dead lanes
    first) goes, for L = n - n_dead live lanes and k = clamp(ceil(L /
    spread), 1, 32)."""
    live = n - n_dead
    k = min(max(-(-live // spread), 1), 32)
    p = np.arange(n)
    j = p - n_dead
    before = n_dead if k == 32 else (np.maximum(j, 0) // k) * (32 - k)
    ahead = 0 if k == 32 else np.minimum(live, k * (p // max(32 - k, 1) + 1))
    return np.where(j >= 0, np.minimum(before, n_dead) + j, p + ahead)


# ---------------------------------------------------------------------------
# CPU

@pytest.mark.parametrize("dead_first", [False, True])
@pytest.mark.parametrize("mode", intersect.PERM_KEYS)
def test_lane_key_op_is_the_plain_key(mode, dead_first):
    """lane_key on the CPU: perm_key (dead lanes -1 under dead_first) on
    the scene box DenseTris derived once, and the count of dead lanes;
    counted as plain, with the lanes under query.prep.plain."""
    dense, phi, tmax = _dense_rays(1100, 300)
    assert torch.equal(dense.scene_box,
                       intersect.scene_box(dense.chunk_bounds))
    cuda_lib.reset_counts()
    with profiling.tracing():
        key, n_dead = torch.ops.tracer_tpu_torch.lane_key(
            phi, tmax, dense.scene_box, mode, dead_first)
    want = intersect.perm_key(phi, dense.chunk_bounds, mode)
    dead = ~(tmax > 0)
    if dead_first:
        want = torch.where(dead, -1, want)
    assert key.dtype == n_dead.dtype == torch.int32
    assert torch.equal(key, want)
    assert n_dead.tolist() == [int(dead.sum()) if dead_first else 0]
    assert cuda_lib.plain_calls["lane_key"] == 1
    assert sum(cuda_lib.launches.values()) == 0
    assert profiling.counters() == {"query.prep.plain": phi.shape[1]}
    profiling.reset()


@pytest.mark.parametrize("spread", SPREADS)
@pytest.mark.parametrize("n_live", LIVE)
def test_sorted_lanes_are_lane_order(n_live, spread, monkeypatch):
    """sorted_lanes (lane_key, a stable sort, lane_deal) gives lane_order's
    permutation and phi and tmax gathered by it, for dead_first with
    SPREAD_WARPS = spread and without dead_first."""
    monkeypatch.setattr(intersect, "SPREAD_WARPS", spread)
    dense, phi, _ = _dense_rays(1100, 1000)
    phi = phi[:, :1000].contiguous()
    tmax = _live_tmax(1000, n_live)
    cb = dense.chunk_bounds
    for dead_first in (True, False):
        order, phi_s, tmax_s = intersect.sorted_lanes(
            dense, phi, tmax, "odmorton", dead_first)
        want = intersect.lane_order(phi, tmax, cb, "odmorton",
                                    dead_first=dead_first)
        assert order.dtype == torch.int64 and torch.equal(order, want)
        assert torch.equal(phi_s, phi[:, want])
        assert torch.equal(tmax_s, tmax[want])
    # a scalar tmax gathers to the same value on every lane
    _, _, tm = intersect.sorted_lanes(dense, phi, torch.tensor(2.0),
                                      "oct", False)
    assert tm.shape == (1000,) and bool((tm == 2.0).all())


@pytest.mark.parametrize("spread", SPREADS + (4096,))
@pytest.mark.parametrize("n_live", LIVE)
def test_deal_closed_form_is_lane_order(n_live, spread, monkeypatch):
    """The positions the deal kernel computes (live rank j to min(before,
    D) + j, dead rank r to r + min(L, k (r // (32 - k) + 1)); at k = 32
    the live lanes after the dead) give lane_order's permutation."""
    monkeypatch.setattr(intersect, "SPREAD_WARPS", spread)
    dense, phi, _ = _dense_rays(1100, 1000)
    phi = phi[:, :1000]
    tmax = _live_tmax(1000, n_live)
    key = intersect.perm_key(phi, dense.chunk_bounds, "odmorton")
    idx = torch.sort(torch.where(tmax > 0, key, -1), stable=True).indices
    dest = _dealt(1000, 1000 - n_live, spread)
    assert sorted(dest.tolist()) == list(range(1000))
    got = torch.empty_like(idx)
    got[torch.as_tensor(dest)] = idx
    assert torch.equal(got, intersect.lane_order(
        phi, tmax, dense.chunk_bounds, "odmorton", dead_first=True))


def test_prep_ops_fake_shapes():
    """The fake rules of lane_key and lane_deal: (N,) int32 keys and a (1,)
    int32 count; (N,) int64 order, (10, N) f32 features and (N,) f32 tmax,
    on phi's device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dense, phi, tmax = _dense_rays(300, 200)
    n = phi.shape[1]
    with FakeTensorMode() as mode:
        fphi, ftmax, fbox = (mode.from_tensor(x)
                             for x in (phi, tmax, dense.scene_box))
        key, n_dead = torch.ops.tracer_tpu_torch.lane_key(
            fphi, ftmax, fbox, "odmorton", True)
        out = torch.ops.tracer_tpu_torch.lane_deal(
            torch.sort(key, stable=True).indices, n_dead, fphi, ftmax, 64)
    assert [(x.shape, x.dtype, x.device.type)
            for x in (key, n_dead, *out)] == [
        ((n,), torch.int32, "cpu"), ((1,), torch.int32, "cpu"),
        ((n,), torch.int64, "cpu"), ((10, n), torch.float32, "cpu"),
        ((n,), torch.float32, "cpu")]


def test_lane_key_refuses_unknown_mode():
    dense, phi, tmax = _dense_rays(300, 20)
    with pytest.raises(ValueError, match="permutation key"):
        torch.ops.tracer_tpu_torch.lane_key(phi, tmax, dense.scene_box,
                                            "morton", True)


def test_walk_operands_count_the_plain_schedule():
    """Off the card walk_operands runs the plain schedule and counts it:
    the superchunk boxes only at g > 1, the tile order only for K1-K4."""
    dense, phi, tmax = _dense_rays(1100, 300)
    cuda_lib.reset_counts()
    ik.walk_operands("any_hit", phi, tmax, dense.chunk_bounds, max_sched=3)
    ik.walk_operands(ik.EXACT, phi, tmax, dense.chunk_bounds)
    assert {k: cuda_lib.plain_calls[k] for k in ik.PREP_KERNELS} == {
        "lane_key": 0, "lane_deal": 0, "superchunk": 1, "schedule": 2,
        "heavy_first": 1}
    assert sum(cuda_lib.launches.values()) == 0


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version, run on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _check_key(dense, phi, tmax, mode, dead_first):
    before = cuda_lib.launches["lane_key"]
    key, n_dead = torch.ops.tracer_tpu_torch.lane_key(
        phi, tmax, dense.scene_box, mode, dead_first)
    want = intersect.perm_key(phi, dense.chunk_bounds, mode)
    dead = ~(tmax > 0)
    if dead_first:
        want = torch.where(dead, -1, want)
    torch.cuda.synchronize()
    assert cuda_lib.launches["lane_key"] == before + 1
    assert torch.equal(key, want)
    assert n_dead.tolist() == [int(dead.sum()) if dead_first else 0]


def _check_prep(dense, phi, tmax, mode, dead_first):
    """Key, dealt order, gathered phi and tmax against the plain
    lane_order on the card."""
    tmax = tmax.expand(phi.shape[1])
    _check_key(dense, phi, tmax, mode, dead_first)
    order, phi_s, tmax_s = intersect.sorted_lanes(dense, phi, tmax, mode,
                                                  dead_first)
    want = intersect.lane_order(phi, tmax, dense.chunk_bounds, mode,
                                dead_first=dead_first)
    torch.cuda.synchronize()
    assert torch.equal(order, want)
    assert _equal_bits(phi_s, phi[:, want])
    assert _equal_bits(tmax_s, tmax[want])


def _check_schedule(name, phi, tmax, cb, max_sched, tile):
    """walk_operands on the card against walk_schedule and heavy_first on
    the card, at `tile` lanes a tile."""
    g, sb, order, count, tiles = ik.walk_operands(name, phi, tmax, cb,
                                                  max_sched)
    wg, wsb, worder, wcount = ik.walk_schedule(phi, tmax, cb, max_sched,
                                               tile)
    torch.cuda.synchronize()
    assert g == wg and torch.equal(sb, wsb)
    assert worder is not None and order.shape == worder.shape
    assert torch.equal(order, worder) and torch.equal(count, wcount)
    if name == ik.EXACT:
        assert tiles is None
    else:
        assert torch.equal(tiles, ik.heavy_first(wcount))
    return count


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dead_first", [False, True])
@pytest.mark.parametrize("mode", intersect.PERM_KEYS)
def test_key_and_deal_kernels_match_plain_on_card(mode, dead_first,
                                                  cuda_device):
    """Every key, dead-first on and off: the key bit for bit, the dead
    count, the dealt order and the gathered phi and tmax, under a mixed
    per-lane tmax (0 and NaN lanes dead) and a broadcast scalar one."""
    dense, phi, tmax = _dense_rays(1100, 3000, cuda_device)
    cuda_lib.reset_counts()
    for tm in (tmax, torch.tensor(1e30, device=cuda_device)):
        _check_prep(dense, phi, tm, mode, dead_first)
    assert cuda_lib.launches["lane_deal"] == 2
    assert sum(cuda_lib.plain_calls.values()) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spread", SPREADS)
@pytest.mark.parametrize("n_live", LIVE)
def test_deal_kernel_matches_lane_order_on_card(n_live, spread,
                                                cuda_device, monkeypatch):
    """The deal at SPREAD_WARPS = spread over 1,000 lanes: no live lane,
    one, fewer than fill 32 x spread lanes, k = 32, and no dead lane."""
    monkeypatch.setattr(intersect, "SPREAD_WARPS", spread)
    dense, phi, _ = _dense_rays(1100, 1000, cuda_device)
    phi = phi[:, :1000].contiguous()
    _check_prep(dense, phi, _live_tmax(1000, n_live, cuda_device),
                "odmorton", True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_live", [0, 1, 50_000, 131_071, 200_000,
                                    300_001])
def test_deal_kernel_at_the_spread_on_card(n_live, cuda_device):
    """At the port's SPREAD_WARPS over 300,001 lanes: k from 1 to 32 (at
    131,071 live lanes k = 32 only just), and no dead lane."""
    n = 300_001
    dense, _, _ = _dense_rays(1100, 10, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(n_live)
    o = torch.rand((3, n), generator=g, device=cuda_device) * 6 - 3
    d = torch.randn((3, n), generator=g, device=cuda_device)
    phi = intersect.ray_features_t(o, d / d.norm(dim=0))
    _check_prep(dense, phi, _live_tmax(n, n_live, cuda_device), "odmorton",
                True)


# (triangles, max_sched): 2 chunks (S = 2); 5; 64 (S = 64, g = 1); 69 at
# g = 2 (S = 35, the last superchunk one chunk and a padding box); 130 at
# g = 44 (S = 3, two padding boxes in the last); 1,025 chunks at g = 17
# (S = 61, the last superchunk one chunk), the big scene's shape
SCHEDULES = {"s2": (400, 64), "s5": (1100, 64), "s64": (64 * 256, 64),
             "g2": (68 * 256 + 3, 64), "g44": (129 * 256 + 9, 3),
             "g17": (1024 * 256 + 2, 64)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_kernels_match_plain_on_card(case, tile, cuda_device,
                                              monkeypatch):
    """The superchunk boxes, each tile's order and count and the tile
    order, bit for bit, at `tile` lanes over a lane count that is no
    multiple of it, under a per-lane tmax (0 and NaN lanes among them) and
    a scalar one; axis-parallel rays on box planes among the lanes."""
    n_tris, max_sched = SCHEDULES[case]
    dense, phi, tmax = _dense_rays(n_tris, 1500, cuda_device)
    cb = dense.chunk_bounds
    assert phi.shape[1] % tile and phi.shape[1] > tile
    monkeypatch.setitem(ik.BLOCKS, "any_hit", tile)
    cuda_lib.reset_counts()
    for tm in (tmax, 1e30):
        count = _check_schedule("any_hit", phi, tm, cb, max_sched, tile)
        assert int(count.max()) > 0
        _check_schedule(ik.EXACT, phi, tm, cb, max_sched, ik.EXACT_BLOCK)
    g = -(-cb.shape[0] // max_sched)
    assert cuda_lib.launches["schedule"] == 4
    assert cuda_lib.launches["superchunk"] == (4 if g > 1 else 0)
    assert cuda_lib.launches["heavy_first"] == 2


def _pool_operands(size_factor, device):
    """The operands of pool iteration 1 of a 2-spp 512x512 render of SPD
    tetra at `size_factor` (the config's camera): (dense, (tmax, phi) of
    the closest query, (tmax, phi) of the any-hit query)."""
    tris, tm, mats = spd_tetra.build(size_factor)
    s = T.init(17, 512, 512, 0, tris, tm, mats,
               cam_origin=spd_tetra.CAMERA_ORIGIN, device=device)
    kept = {q: getattr(intersect, f"{q}_hit_phi") for q in ("closest", "any")}
    got = {q: [] for q in kept}

    def tap(q):
        def tapped(dense, tmax, phi, **kw):
            got[q].append((tmax.clone(), phi.clone()) if len(got[q]) == 1
                          else None)
            return kept[q](dense, tmax, phi, **kw)
        return tapped
    try:
        for q in kept:
            setattr(intersect, f"{q}_hit_phi", tap(q))
        T.sample_n_frames(s, 3)   # 2 spp
    finally:
        for q, fn in kept.items():
            setattr(intersect, f"{q}_hit_phi", fn)
    return s.scene.accel, got["closest"][1], got["any"][1]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("size_factor", [4, 8])
def test_pool_operands_of_spd_tetra_on_card(size_factor, cuda_device):
    """On the closest and any-hit queries of pool iteration 1 of SPD tetra
    (size factor 4: 5 chunks, K1/K3; 8: 1,025 chunks, g = 17, 524,288
    and 1,048,576 lanes, K2/K4): key, dealt order, gathered operands,
    schedule and tile order bit for bit the plain versions'; and the
    queries' answers (closest_hit_phi, any_hit_phi, sorted by odmorton)
    bit for bit those of the plain preparation on the same lanes, with
    one kernel launch each and query.prep.kernel = the lanes."""
    dense, (ct, cphi), (at, aphi) = _pool_operands(size_factor, cuda_device)
    cb = dense.chunk_bounds
    streamed = ik.streamed_variant(dense.coeffs.shape[1])
    assert streamed == (size_factor == 8)
    if size_factor == 8:
        assert (cphi.shape[1], aphi.shape[1]) == (524_288, 1_048_576)
    for q, tm, phi in (("closest", ct, cphi), ("any", at, aphi)):
        per_lane = tm.dim() > 0
        _check_prep(dense, phi, tm, "odmorton", per_lane or q == "any")
        _, phi_s, tmax_s = intersect.sorted_lanes(
            dense, phi, tm, "odmorton", per_lane or q == "any")
        name = ik.variant_name(q, streamed)
        _check_schedule(name, phi_s, tmax_s, cb, ik.MAX_SCHED,
                        ik.BLOCKS[name])
        # the answers against the plain preparation's
        tm_n = tm.expand(phi.shape[1])
        want = intersect.lane_order(phi, tm_n, cb, "odmorton",
                                    dead_first=per_lane or q == "any")
        profiling.reset()
        with profiling.tracing():
            if q == "closest":
                got = intersect.closest_hit_phi(dense, tm, phi,
                                                perm="odmorton")
            else:
                got = (intersect.any_hit_phi(dense, tm, phi,
                                             perm="odmorton"),)
        assert profiling.counters()["query.prep.kernel"] == phi.shape[1]
        assert "query.prep.plain" not in profiling.counters()
        assert profiling.summary()["query.schedule"]["count"] == 1
        profiling.reset()
        if q == "closest":
            bt, bi = ik.closest_hit(dense.coeffs, phi[:, want], tm_n[want],
                                    cb)
            ref = (torch.empty_like(bt), torch.empty_like(bi))
            ref[0][want], ref[1][want] = bt, bi
        else:
            h = ik.any_hit(dense.coeffs, phi[:, want], tm_n[want], cb)
            ref = (torch.empty_like(h),)
            ref[0][want] = h
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert _equal_bits(a, b)
        hits = int((torch.isfinite(got[0]) if q == "closest"
                    else got[0]).sum())
        assert 0 < hits < phi.shape[1]
