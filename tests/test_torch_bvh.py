"""Port parity: the LBVH accel of tracer_tpu_torch (ops/radix_tree.py,
ops/bvh.py, the boxes of ops/shapes.py, the scene's dispatch) against
the JAX package on the same numpy triangles: the cases of
tests/test_bvh.py. Trees and node boxes are equal exactly; hits agree
with the port's dense accel and with the JAX LBVH. The walk's ops
(tracer_tpu_torch::lbvh_closest_hit / lbvh_any_hit): their CPU version
is the plain walk, counted; their fake rules; a scaled SPD tetra against
a brute-force test of every triangle; "auto" builds the LBVH past the
dense cap."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tracer_tpu as J
from tracer_tpu.engine import integrator as jint
from tracer_tpu.ops import bvh as jbvh
from tracer_tpu.ops import radix_tree as jradix
from tracer_tpu.ops import shapes as jshapes
from tracer_tpu.utils import testscenes
import tracer_tpu_torch as T
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.models import scene as tscene
from tracer_tpu_torch.ops import bvh as tbvh
from tracer_tpu_torch.ops import intersect as tintersect
from tracer_tpu_torch.ops import linalg as tla
from tracer_tpu_torch.ops import radix_tree as tradix
from tracer_tpu_torch.ops import shapes as tshapes
from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.utils import convert, profiling

torch.set_num_threads(2)


def random_tris(rng_np, t, scale=3.0, size=0.5):
    base = rng_np.uniform(-scale, scale, (t, 1, 3))
    offs = rng_np.uniform(-size, size, (t, 3, 3))
    return (base + offs).astype(np.float32)


def random_rays(rng_np, n):
    o = rng_np.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_clz32_exact():
    words = [0, 1, 2, 3, 2**31 - 1, 2**31, 2**31 + 1, 0xFFFFFFFF, 12345,
             2**24, 2**24 + 1, 2**30]
    got = tradix.clz32(torch.tensor(words, dtype=torch.int64)).tolist()
    assert got == [32 - w.bit_length() for w in words]
    assert got[0] == 32 and got[1] == 31 and got[5] == 0 and got[7] == 0
    want = np.asarray(jax.lax.clz(jnp.asarray(words, jnp.uint32)))
    np.testing.assert_array_equal(got, want)


def _tree_equal(codes):
    want = jradix.build(jnp.asarray(codes))
    got = tradix.build(torch.as_tensor(codes.astype(np.int64)))
    for name in ("left", "right", "parent"):
        g = getattr(got, name)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("n", [2, 3, 5, 17, 64, 255])
def test_radix_tree_matches_jax(n):
    rng_np = np.random.default_rng(n)
    _tree_equal(np.sort(rng_np.integers(0, 2**30, n, dtype=np.uint32)))


@pytest.mark.parametrize("case", ["all_equal", "runs", "top_bit"])
def test_radix_tree_duplicate_codes(case):
    """Equal codes go on into the prefix of their indices (32 + clz of
    i ^ j, with clz(0) = 32 for a node against itself)."""
    rng_np = np.random.default_rng(7)
    if case == "all_equal":
        codes = np.full(33, 12345, np.uint32)
    elif case == "runs":
        codes = np.sort(rng_np.integers(0, 6, 40, dtype=np.uint32) * 977)
    else:
        codes = np.sort(np.concatenate([
            rng_np.integers(0, 2**32, 30, dtype=np.uint64).astype(np.uint32),
            np.full(3, 0xFFFFFFFF, np.uint32), np.zeros(2, np.uint32)]))
    _tree_equal(codes)


def test_pointer_encoding_matches_jax():
    ptr = np.arange(0, 12, dtype=np.int32)
    for fn in ("leaf_ptr", "is_leaf", "leaf_index"):
        np.testing.assert_array_equal(
            getattr(tradix, fn)(torch.as_tensor(ptr), 5).numpy(),
            np.asarray(getattr(jradix, fn)(jnp.asarray(ptr), 5)))


def test_boxes_match_jax():
    rng_np = np.random.default_rng(3)
    tris = random_tris(rng_np, 40)
    tmin, tmax = tshapes.bounding_box_triangle(torch.as_tensor(tris))
    jmin, jmax = jshapes.bounding_box_triangle(jnp.asarray(tris))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    np.testing.assert_array_equal(
        tshapes.aabb_center(tmin, tmax).numpy(),
        np.asarray(jshapes.aabb_center(jmin, jmax)))
    o, d = random_rays(rng_np, 40)
    d[::5, 0] = 0.0   # axis-parallel rays: the slab test divides by zero
    for tm in (1e30, 2.0):
        # boxes wide enough for about half the rays to cross them
        got = tshapes.hit_aabb_v(torch.tensor(tm), torch.as_tensor(o).T,
                                 1.0 / torch.as_tensor(d).T,
                                 (tmin - 2.0).T, (tmax + 2.0).T)
        want = jshapes.hit_aabb(jnp.float32(tm), jnp.asarray(o),
                                jnp.asarray(d), jmin - 2.0, jmax + 2.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any() and not got.all()


@pytest.mark.parametrize("t", [2, 5, 50, 333])
def test_build_matches_jax_and_contains_children(t):
    """Order, tree and node boxes equal the JAX LBVH exactly (the sort is
    stable in both), and every node's box holds its children's."""
    rng_np = np.random.default_rng(t)
    tris = random_tris(rng_np, t)
    if t == 50:
        tris[10:20] = tris[5]   # duplicate triangles, duplicate codes
    want = jbvh.build(jnp.asarray(tris))
    got = tbvh.build(torch.as_tensor(tris))
    for name in ("perm", "left", "right", "parent", "tris", "node_min",
                 "node_max"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    n_int = t - 1
    nmin, nmax = got.node_min.numpy(), got.node_max.numpy()
    lmin, lmax = (x.numpy() for x in tshapes.bounding_box_triangle(got.tris))
    for i in range(n_int):
        for c in (int(got.left[i]), int(got.right[i])):
            cmin, cmax = ((lmin[c - n_int], lmax[c - n_int]) if c >= n_int
                          else (nmin[c], nmax[c]))
            assert (nmin[i] <= cmin).all() and (nmax[i] >= cmax).all(), i


@pytest.mark.parametrize("t", [2, 5, 60, 333])
def test_lbvh_closest_matches_dense_and_jax(t):
    rng_np = np.random.default_rng(100 + t)
    tris = random_tris(rng_np, t)
    o, d = random_rays(rng_np, 257)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    b = tbvh.build(torch.as_tensor(tris))
    ok_b, t_b, i_b, pos_b, nrm_b = tbvh.closest_hit(
        b, 1e30, tla.v3_from_array(to), tla.v3_from_array(td))
    pos_b, nrm_b = tla.v3_to_array(pos_b), tla.v3_to_array(nrm_b)
    # the JAX LBVH: the same leaf off ties, t within 1e-6
    ok_j, t_j, i_j, pos_j, nrm_j = jbvh.closest_hit(
        jbvh.build(jnp.asarray(tris)), 1e30, jnp.asarray(o), jnp.asarray(d))
    hit = ok_b.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ok_j))
    np.testing.assert_allclose(t_b.numpy()[hit], np.asarray(t_j)[hit],
                               rtol=1e-6, atol=1e-6)
    same = i_b.numpy() == np.asarray(i_j)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(t_b.numpy()[~same], np.asarray(t_j)[~same],
                               rtol=1e-3)
    np.testing.assert_allclose(pos_b.numpy()[hit & same],
                               np.asarray(pos_j)[hit & same], atol=1e-5)
    np.testing.assert_allclose(nrm_b.numpy()[hit & same],
                               np.asarray(nrm_j)[hit & same], atol=1e-5)
    # the port's dense accel
    dense = tintersect.build_dense(torch.as_tensor(tris))
    ok_d, t_d, i_d, _, _, _ = tintersect.closest_hit(
        dense, 1e30, tla.v3_from_array(to), tla.v3_from_array(td))
    np.testing.assert_array_equal(hit, ok_d.numpy())
    np.testing.assert_allclose(t_b.numpy()[hit], t_d.numpy()[hit],
                               rtol=1e-4, atol=1e-5)
    i_d = dense.perm[torch.where(i_d >= 0, i_d, 0).long()].numpy()
    diff = hit & (i_b.numpy() != i_d)
    np.testing.assert_allclose(t_b.numpy()[diff], t_d.numpy()[diff],
                               rtol=1e-3)


@pytest.mark.parametrize("tm", [1e30, 3.0])
def test_lbvh_any_hit_matches_dense_and_jax(tm):
    rng_np = np.random.default_rng(11)
    tris = random_tris(rng_np, 64)
    o, d = random_rays(rng_np, 129)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    got = tbvh.any_hit(tbvh.build(torch.as_tensor(tris)), tm,
                       tla.v3_from_array(to), tla.v3_from_array(td)).numpy()
    want_j = np.asarray(jbvh.any_hit(jbvh.build(jnp.asarray(tris)), tm,
                                     jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_array_equal(got, want_j)
    dense = tintersect.build_dense(torch.as_tensor(tris))
    want_d = tintersect.any_hit(dense, tm, tla.v3_from_array(to),
                                tla.v3_from_array(td)).numpy()
    np.testing.assert_array_equal(got, want_d)
    assert got.any() and not got.all()


def test_lbvh_respects_per_lane_tmax():
    rng_np = np.random.default_rng(12)
    tris = random_tris(rng_np, 32)
    o, d = (tla.v3_from_array(torch.as_tensor(x))
            for x in random_rays(rng_np, 64))
    b = tbvh.build(torch.as_tensor(tris))
    ok_far, t_far, _, _, _ = tbvh.closest_hit(b, 1e30, o, d)
    assert ok_far.any()
    # a tmax below each lane's hit: every such lane must miss
    tm = torch.where(torch.isfinite(t_far), t_far * 0.9, 0.5)
    ok_near, _, _, _, _ = tbvh.closest_hit(b, tm, o, d)
    assert not (ok_near & ok_far).any()
    assert not tbvh.any_hit(b, tm, o, d)[ok_far].any()
    # a dead lane (tmax 0) hits nothing
    dead = torch.where(torch.arange(64) % 2 == 0, 1e30, 0.0)
    ok_half, _, i_half, _, _ = tbvh.closest_hit(b, dead, o, d)
    assert not ok_half[1::2].any() and (i_half[1::2] == -1).all()
    np.testing.assert_array_equal(ok_half[::2].numpy(), ok_far[::2].numpy())


def _lbvh_states(size):
    js = J.init(0, size, size, 0, *testscenes.cornell_like(),
                cam_origin=(0.0, 0.8, 1.8), accel="lbvh")
    return js, convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")


def test_converted_lbvh_state_renders_as_jax():
    """Both packages trace the very same tree; sample_pixels lane for
    lane, at the tolerance of tests/test_torch_integrator.py."""
    js, ts = _lbvh_states(16)
    assert isinstance(ts.scene.accel, tbvh.LBVH)
    w, h = js.sub_dims
    jsam = jint.sample_pixels(js.seed, js.nonce + jnp.uint32(2), js.scene,
                              js.cam, js.ambience, w, h, js.transmitter_kind)
    tsam = tint.sample_pixels(ts.seed, ts.nonce + 2, ts.scene, ts.cam,
                              ts.ambience, w, h, ts.transmitter_kind)
    np.testing.assert_array_equal(tsam.channel.numpy(),
                                  np.asarray(jsam.channel))
    jr = np.asarray(jsam.path.radiance)
    tr = tsam.path.radiance.numpy()
    assert (jr > 0).any(axis=0).mean() > 0.5
    lane_ok = np.isclose(tr, jr, rtol=1e-4, atol=1e-5).all(axis=0)
    assert lane_ok.mean() >= 0.995, np.nonzero(~lane_ok)[0]
    dist_ok = np.isclose(tsam.path.distance.numpy(),
                         np.asarray(jsam.path.distance),
                         rtol=1e-4, atol=1e-5).all(axis=0)
    assert dist_ok.mean() >= 0.995
    assert abs(tsam.rays_traced - int(jsam.rays_traced)) <= 0.01 * int(
        jsam.rays_traced)


def test_built_lbvh_scene_matches_dense_scene():
    """build_scene(accel="lbvh"): tri_mat in input order, the hit's
    material from tri_mat[tri_idx]; a render through the API agrees with
    the dense accel's."""
    args = testscenes.cornell_like()
    lb = T.init(0, 12, 12, 0, *args, cam_origin=(0.0, 0.8, 1.8),
                accel="lbvh", device="cpu")
    de = T.init(0, 12, 12, 0, *args, cam_origin=(0.0, 0.8, 1.8),
                accel="dense", device="cpu")
    assert isinstance(lb.scene.accel, tbvh.LBVH)
    np.testing.assert_array_equal(lb.scene.tri_mat.numpy(),
                                  np.asarray(args[1], np.int32))
    img_l = T.sample_n_frames(lb, 5).numpy()
    img_d = T.sample_n_frames(de, 5).numpy()
    assert img_d.max() > 0.5
    px_ok = np.isclose(img_l, img_d, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert px_ok.mean() >= 0.97, np.argwhere(~px_ok)
    # closest_hit returns input-order indices for the LBVH
    o = torch.tensor([[0.0], [0.8], [1.8]])
    d = tla.v3_normalize(torch.tensor([[0.1, -0.2, -0.3], [0.0, 0.1, -0.5],
                                       [-1.0, -1.0, -1.0]]).T.contiguous())
    ok_l, t_l, i_l, _, _ = tscene.closest_hit(lb.scene, 1e30, o, d)
    ok_d, t_d, i_d, _, _ = tscene.closest_hit(de.scene, 1e30, o, d)
    assert ok_l.all() and ok_d.all()
    np.testing.assert_allclose(t_l.numpy(), t_d.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(
        i_l.numpy(), de.scene.accel.perm[i_d.long()].numpy())


def test_auto_above_threshold_raises_value_error(monkeypatch):
    """"auto" is the dense accel up to the dense cap and the LBVH above
    it (the JAX package's "auto" refuses such a scene: its walk has no
    kernel); an unknown accel raises a ValueError."""
    args = testscenes.cornell_like()
    assert isinstance(tscene.build_scene(*args, accel="auto",
                                         device="cpu").accel,
                      tintersect.DenseTris)
    monkeypatch.setattr(tscene, "DENSE_THRESHOLD", 10)
    sc = tscene.build_scene(*args, accel="auto", device="cpu")
    assert isinstance(sc.accel, tbvh.LBVH)
    np.testing.assert_array_equal(sc.tri_mat.numpy(),
                                  np.asarray(args[1], np.int32))
    with pytest.raises(ValueError, match="unknown accel"):
        tscene.build_scene(*args, accel="kdtree", device="cpu")
    sc = tscene.build_scene(*args, accel="lbvh", device="cpu")
    assert isinstance(sc.accel, tbvh.LBVH)


def _op_args(rng_np, t=60, n=97):
    """The ops' operands on random triangles and rays, with dead (tmax
    0), NaN and per-lane tmax lanes and axis-parallel rays."""
    tris = random_tris(rng_np, t)
    o, d = random_rays(rng_np, n)
    d[::6, 1] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = rng_np.uniform(0.5, 9.0, n).astype(np.float32)
    tm[::9], tm[4::9] = 0.0, np.nan
    b = tbvh.build(torch.as_tensor(tris))
    return b, tbvh.op_args(b, torch.as_tensor(tm),
                           tla.v3_from_array(torch.as_tensor(o)),
                           tla.v3_from_array(torch.as_tensor(d)))


@pytest.mark.parametrize("query", ["closest", "any"])
def test_ops_cpu_version_is_the_plain_walk_counted(query):
    """On the CPU each op is the plain walk (ops/bvh._traverse), output
    for output; each call is counted as a plain call of its kernel and
    adds its lanes to query.lanes.<kernel>, never query.tris (a launch's
    alone)."""
    b, args = _op_args(np.random.default_rng(31))
    name = "lbvh_" + query
    op = getattr(torch.ops.tracer_tpu_torch, name + "_hit")
    want = tbvh._traverse(*args, any_hit=query == "any")
    cuda_lib.reset_counts()
    profiling.reset()
    try:
        with profiling.tracing():
            got = op(*args)
        c = profiling.counters()
    finally:
        profiling.reset()
    if query == "any":
        assert got.dtype == torch.bool and torch.equal(got, want[0])
        assert got.any() and not got.all()
    else:
        leaf, t = got
        assert leaf.dtype == torch.int64 and t.dtype == torch.float32
        assert torch.equal(leaf, want[0])
        assert torch.equal(t.view(torch.int32), want[1].view(torch.int32))
        assert (leaf >= 0).any() and (leaf < 0).any()
    assert cuda_lib.plain_calls[name] == 1 and cuda_lib.launches[name] == 0
    assert c["query.lanes." + name] == 97
    assert "query.tris." + name not in c
    cuda_lib.reset_counts()


def test_ops_fake_rules():
    """The fake rules give torch.export the outputs' shapes and dtypes
    without running the walk."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _, args = _op_args(np.random.default_rng(32), n=41)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(x) for x in args]
        leaf, t = torch.ops.tracer_tpu_torch.lbvh_closest_hit(*fake)
        hit = torch.ops.tracer_tpu_torch.lbvh_any_hit(*fake)
    assert (leaf.shape, leaf.dtype) == ((41,), torch.int64)
    assert (t.shape, t.dtype) == ((41,), torch.float32)
    assert (hit.shape, hit.dtype) == ((41,), torch.bool)


def _tetra_x4(size_factor):
    """SPD tetra's faces (portbench/scenes/spd_tetra.py) at size_factor,
    every length x4 as the size-factor-10 configuration has them."""
    from portbench.scenes import spd_tetra_sf10
    from portbench.scenes.spd_tetra import faces
    return spd_tetra_sf10.place(faces(size_factor)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_scaled_tetra_against_every_triangle(seed):
    """A x4-scaled tetra of size factor 3 (256 faces): the LBVH's closest
    t and any hit on seeded random rays agree with a brute-force test of
    every triangle (ops/intersect.closest_hit_bruteforce), lane for lane
    off rays that graze a triangle's edge."""
    tris = _tetra_x4(3)
    r = np.random.default_rng(40 + seed)
    n = 384
    o = r.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    o[:, 2] += 10.0
    d = (r.uniform(-4.0, 4.0, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = r.uniform(5.0, 25.0, n).astype(np.float32)
    b = tbvh.build(torch.as_tensor(tris))
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    ok, t, idx, _, _ = tbvh.closest_hit(b, torch.as_tensor(tm),
                                        tla.v3_from_array(to),
                                        tla.v3_from_array(td))
    hit_w, t_w, i_w = tintersect.closest_hit_bruteforce(
        torch.as_tensor(tris), torch.as_tensor(tm)[:, None], to, td)
    assert 0.2 < float(ok.float().mean()) < 0.95
    np.testing.assert_array_equal(ok.numpy(), hit_w.numpy())
    np.testing.assert_allclose(t.numpy()[ok.numpy()],
                               t_w.numpy()[ok.numpy()], rtol=1e-6)
    same = (idx == i_w).numpy()
    assert same.mean() >= 0.99
    anyh = tbvh.any_hit(b, torch.as_tensor(tm), tla.v3_from_array(to),
                        tla.v3_from_array(td))
    np.testing.assert_array_equal(anyh.numpy(), hit_w.numpy())
