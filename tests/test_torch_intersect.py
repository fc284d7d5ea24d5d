"""Port parity: the dense intersector of tracer_tpu_torch (build_dense, the
plain versions of both kernels behind closest_hit / any_hit, the
brute-force oracle) against the JAX package's exact XLA path and its
Pallas kernels in interpret mode. On CPU tensors the wrappers run the
plain versions and launch no kernel; the kernels themselves are held to
the plain versions on the card (marked requires_cuda)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tracer_tpu.ops import intersect as jint
from tracer_tpu.ops import linalg as jla
from tracer_tpu.ops.pallas import intersect_kernel as pk
from tracer_tpu.utils import testscenes
from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.ops import intersect as tint
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.utils import kernel_cases as kc

torch.set_num_threads(2)

# name -> (triangles, rays, expected chunk count)
CASES = {"random300": (300, 257, 3), "chunks5": (1100, 300, 5)}


def _case(name):
    n_tris, n_rays, n_chunks = CASES[name]
    tris, o, d = kc.random_case(n_tris, n_rays)
    jd = jint.build_dense(jnp.asarray(tris))
    assert jd.chunk_bounds.shape[0] == n_chunks
    po, pdir = kc.on_plane_rays(np.asarray(jd.chunk_bounds))
    return tris, jd, np.concatenate([o, po]), np.concatenate([d, pdir])


def _dense_t(jd):
    return tint.DenseTris(
        coeffs=torch.as_tensor(np.array(jd.coeffs)),
        tris=torch.as_tensor(np.array(jd.tris)),
        perm=torch.as_tensor(np.array(jd.perm)),
        chunk_bounds=torch.as_tensor(np.array(jd.chunk_bounds)))


def _v3j(a):
    return jla.v3_from_array(jnp.asarray(a))


def _v3t(a):
    return torch.as_tensor(np.ascontiguousarray(a.T))


def _scene_tris(name):
    if name in CASES:
        return _case(name)[0], None
    tris, tm, _ = {"cornell": testscenes.cornell_like,
                   "prism": testscenes.prism_scene}[name]()
    return tris, tm.astype(np.float32)


@pytest.mark.parametrize("name", ["cornell", "prism", "random300", "chunks5"])
def test_build_dense(name):
    tris, aux = _scene_tris(name)
    jd = jint.build_dense(jnp.asarray(tris), aux=aux)
    td = tint.build_dense(torch.as_tensor(tris),
                          aux=None if aux is None else torch.as_tensor(aux))
    np.testing.assert_array_equal(td.perm.numpy(), np.asarray(jd.perm))
    np.testing.assert_allclose(td.coeffs.numpy(), np.asarray(jd.coeffs),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.tris.numpy(), np.asarray(jd.tris),
                               rtol=1e-6)
    np.testing.assert_array_equal(td.chunk_bounds.numpy(),
                                  np.asarray(jd.chunk_bounds))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_xla(name):
    _, jd, o, d = _case(name)
    td = _dense_t(jd)
    J = jint.closest_hit(jd, 1e30, _v3j(o), _v3j(d))
    T = tint.closest_hit(td, 1e30, _v3t(o), _v3t(d))
    ok = np.asarray(J[0])
    assert ok.mean() > 0.3
    np.testing.assert_array_equal(T[0].numpy(), ok)
    np.testing.assert_array_equal(T[2].numpy(), np.asarray(J[2]))
    np.testing.assert_allclose(T[1].numpy()[ok], np.asarray(J[1])[ok],
                               rtol=1e-6)
    for j, t in zip(J[3:], T[3:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    n = o.shape[0]
    tmaxes = np.where(np.arange(n) % 3 == 0, 0.0, 4.0).astype(np.float32)
    for tmax in (4.0, tmaxes):
        hj = np.asarray(jint.any_hit(jd, jnp.asarray(tmax), _v3j(o), _v3j(d)))
        ht = tint.any_hit(td, torch.as_tensor(tmax), _v3t(o), _v3t(d))
        np.testing.assert_array_equal(ht.numpy(), hj)
    assert not ht.numpy()[::3].any()  # tmax 0 never hits


# variant -> (TRACER_STREAM_COEFFS, MAX_SCHED of the JAX kernels, the
# port's wrapper options); chunks5 at MAX_SCHED 3 walks g = 2 with a
# padded superchunk
VARIANTS = {"resident": ("0", 64, {"stream": False}),
            "streamed_g2": ("1", 3, {"stream": True, "max_sched": 3})}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name, variant, monkeypatch):
    # exact divide in the Pallas kernel; its scores are bf16x3 products
    # (~2^-15 of each term, so t carries up to ~1e-3 where n.s cancels):
    # compare away from the lanes within 1e-3 of a validity boundary
    stream_env, max_sched, kw = VARIANTS[variant]
    monkeypatch.setenv("TRACER_APPROX_RECIP", "0")
    monkeypatch.setenv("TRACER_STREAM_COEFFS", stream_env)
    monkeypatch.setattr(pk, "MAX_SCHED", max_sched)
    _, jd, o, d = _case(name)
    td = _dense_t(jd)
    phi_j = jint.ray_features_t(_v3j(o), _v3j(d))
    phi_t = tint.ray_features_t(_v3t(o), _v3t(d))
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=1e-6)
    bt_j, bi_j = pk.closest_hit_pallas(jd.coeffs, phi_j, 1e30, jd.chunk_bounds,
                                       interpret=True)
    bt, bi = ik.closest_hit(td.coeffs, phi_t, 1e30, td.chunk_bounds, **kw)
    edge, tie = kc.boundary_lanes(td.coeffs, phi_t, 1e30, td.chunk_bounds,
                                  rel=1e-3)
    keep = ~edge.numpy()
    hit = np.isfinite(np.asarray(bt_j))
    np.testing.assert_array_equal(np.isfinite(bt.numpy())[keep], hit[keep])
    both = keep & hit
    np.testing.assert_allclose(bt.numpy()[both], np.asarray(bt_j)[both],
                               rtol=1e-3, atol=2e-3)
    same = both & ~tie.numpy()
    np.testing.assert_array_equal(bi.numpy()[same], np.asarray(bi_j)[same])

    n = o.shape[0]
    tmaxes = np.where(np.arange(n) % 3 == 0, 0.0, 4.0).astype(np.float32)
    hp = np.asarray(pk.any_hit_pallas(jd.coeffs, phi_j, jnp.asarray(tmaxes),
                                      jd.chunk_bounds, interpret=True))
    ht = ik.any_hit(td.coeffs, phi_t, torch.as_tensor(tmaxes),
                    td.chunk_bounds, **kw).numpy()
    edge, _ = kc.boundary_lanes(td.coeffs, phi_t, torch.as_tensor(tmaxes),
                                td.chunk_bounds, rel=1e-3)
    keep = ~edge.numpy()
    np.testing.assert_array_equal(ht[keep], hp[keep])


def test_on_plane_exact_hits():
    """Axis-parallel rays on the Cornell box's bound planes (the one chunk's
    box is the box itself) hit walls at exactly representable points."""
    tris, tm, _ = testscenes.cornell_like()
    jd = jint.build_dense(jnp.asarray(tris), aux=tm.astype(np.float32))
    td = _dense_t(jd)
    o, d = kc.cornell_plane_rays()
    J = jint.closest_hit(jd, 1e30, _v3j(o), _v3j(d))
    T = tint.closest_hit(td, 1e30, _v3t(o), _v3t(d))
    assert T[0].numpy().all()
    np.testing.assert_array_equal(T[0].numpy(), np.asarray(J[0]))
    np.testing.assert_array_equal(T[1].numpy(), np.asarray(J[1]))
    np.testing.assert_array_equal(T[5].numpy(), np.asarray(J[5]))
    phi = jint.ray_features_t(_v3j(o), _v3j(d))
    bt_p, _ = pk.closest_hit_pallas(jd.coeffs, phi, 1e30, jd.chunk_bounds,
                                    interpret=True)
    np.testing.assert_array_equal(np.isfinite(np.asarray(bt_p)),
                                  T[0].numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_bruteforce_oracle(name):
    tris, jd, o, d = _case(name)
    td = _dense_t(jd)
    J = jint.closest_hit_bruteforce(jnp.asarray(tris), 1e30, jnp.asarray(o),
                                    jnp.asarray(d))
    B = tint.closest_hit_bruteforce(torch.as_tensor(tris), 1e30,
                                    torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(B[0].numpy(), np.asarray(J[0]))
    np.testing.assert_array_equal(B[2].numpy(), np.asarray(J[2]))
    np.testing.assert_allclose(B[1].numpy(), np.asarray(J[1]), rtol=1e-5,
                               atol=1e-6)
    # the dense path finds the same winner, in storage order
    T = tint.closest_hit(td, 1e30, _v3t(o), _v3t(d))
    np.testing.assert_array_equal(T[0].numpy(), B[0].numpy())
    ok = B[0].numpy()
    perm = td.perm.numpy()
    np.testing.assert_array_equal(perm[T[2].numpy()[ok]], B[2].numpy()[ok])
    np.testing.assert_allclose(T[1].numpy()[ok], B[1].numpy()[ok], rtol=1e-5,
                               atol=1e-6)


def test_cpu_tensors_run_plain_versions_only():
    _, jd, o, d = _case("random300")
    td = _dense_t(jd)
    cuda_lib.reset_counts()
    tint.closest_hit(td, 1e30, _v3t(o), _v3t(d))
    tint.any_hit(td, 4.0, _v3t(o), _v3t(d))
    phi = tint.ray_features_t(_v3t(o), _v3t(d))
    ik.closest_hit(td.coeffs, phi, 1e30, td.chunk_bounds, stream=True)
    ik.any_hit(td.coeffs, phi, 4.0, td.chunk_bounds, stream=True)
    bt, bi = ik.closest_hit_exact(td.coeffs, phi, 1e30, td.chunk_bounds)
    rt, ri = ik.closest_hit_ref(td.coeffs, phi, 1e30, td.chunk_bounds)
    assert torch.equal(bt, rt) and torch.equal(bi, ri)
    assert cuda_lib.launches == dict.fromkeys(cuda_lib.KERNELS, 0)
    assert {k: cuda_lib.plain_calls[k] for k in ik.KERNELS} == dict.fromkeys(
        ik.KERNELS, 1)
    with pytest.raises(ValueError):
        ik.closest_hit(td.coeffs, torch.zeros((9, 4)), 1.0, td.chunk_bounds)
    with pytest.raises(ValueError):
        ik.any_hit(td.coeffs, torch.zeros((10, 4)), torch.ones(3),
                   td.chunk_bounds)


def test_stats_and_prepared_launch_need_the_card():
    """The stats counts and prepared_launch describe a kernel's work: a
    CPU call of closest_hit or any_hit with stats raises, streamed or
    resident, as does prepared_launch on CPU tensors or with an unknown
    query, and no count moves."""
    _, jd, o, d = _case("chunks5")
    td = _dense_t(jd)
    phi = tint.ray_features_t(_v3t(o), _v3t(d))
    cuda_lib.reset_counts()
    for call in (ik.closest_hit, ik.any_hit):
        for stream in (True, False):
            with pytest.raises(ValueError):
                call(td.coeffs, phi, 1e30, td.chunk_bounds, stream=stream,
                     stats=torch.zeros(2, dtype=torch.int64))
    for query in ("closest", "any", "exact", "nearest"):
        with pytest.raises(ValueError):
            ik.prepared_launch(query, td.coeffs, phi, 1e30, td.chunk_bounds)
    with pytest.raises(ValueError, match="no streamed variant"):
        ik.prepared_launch("exact", td.coeffs, phi, 1e30, td.chunk_bounds,
                           stream=True)
    assert cuda_lib.launches == dict.fromkeys(cuda_lib.KERNELS, 0)
    assert cuda_lib.plain_calls == dict.fromkeys(cuda_lib.KERNELS, 0)
    assert ik.variant_name("closest", True) == "closest_hit_streamed"
    assert ik.variant_name("exact", False) == ik.EXACT == "closest_hit_exact"
    assert ik.KERNELS == ik.VARIANTS + (ik.EXACT,)
    assert ik.BLOCKS == {"closest_hit": ik.BLOCK,
                         "closest_hit_streamed": ik.STREAMED_CLOSEST_BLOCK,
                         "any_hit": ik.ANY_BLOCK,
                         "any_hit_streamed": ik.STREAMED_ANY_BLOCK,
                         "closest_hit_exact": ik.EXACT_BLOCK}


@pytest.mark.parametrize("name", ik.KERNELS)
def test_operand_rules_of_each_kernel(name):
    """What a kernel takes of its operands, checked before any launch: the
    resident kernels stage a whole chunk in 48 KB (at most 307 triangles),
    the streamed ones stage pieces of a chunk of any size; K1-K4 copy
    8-byte pieces and need coeffs 8-byte aligned (a float32 view one
    element into its storage is not), the exact kernel stages through
    registers and does not; operands are contiguous (cuda_lib.operand)."""
    streamed = name.endswith("_streamed")
    assert ik.MAX_CHUNK_T == {"resident": 307, "streamed": None}
    phi, tmax = torch.zeros((10, 4)), torch.ones(4)
    cb = torch.zeros((2, 8))

    def operands(chunk_t, offset=0):
        flat = torch.zeros(offset + 4 * 2 * chunk_t * 10)
        co = flat[offset:].view(4, 2 * chunk_t, 10)
        assert co.data_ptr() % 8 == 4 * (offset % 2)
        return ik._cuda_operands(name, co, phi, tmax, cb, chunk_t)

    assert all(x.is_contiguous() for x in operands(256))
    if streamed:
        operands(2048)
    else:
        operands(307)
        with pytest.raises(ValueError, match="exceeds the resident"):
            operands(308)
    if name == ik.EXACT:
        operands(256, offset=1)
    else:
        with pytest.raises(ValueError, match="8-byte aligned"):
            operands(256, offset=1)
    with pytest.raises(ValueError, match="contiguous"):
        ik._cuda_operands(name, torch.zeros((4, 512, 20))[:, :, ::2], phi,
                          tmax, cb, 256)


@pytest.mark.parametrize("bad", [
    {"stream": 1}, {"stream": "auto"}, {"max_sched": 0}, {"max_sched": 65},
    {"max_sched": 2.0}, {"perm": "bogus"}, {"perm": "on"}])
def test_bad_walk_options_raise(bad):
    """stream is None, True or False; 1 <= max_sched <= 64; perm is
    "auto", "off" or a key name (the JAX _perm_key would take any name
    as odmorton)."""
    _, jd, o, d = _case("random300")
    td = _dense_t(jd)
    phi = tint.ray_features_t(_v3t(o), _v3t(d))
    with pytest.raises(ValueError):
        tint.closest_hit_phi(td, 1e30, phi, **bad)
    with pytest.raises(ValueError):
        tint.any_hit_phi(td, 4.0, phi, **bad)


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_needed_tests_counts_entered_chunks(name, query):
    """kernel_cases.needed_tests (the count behind the kernels' bound)
    against a lane-by-lane numpy slab test: closest, the chunks each ray
    enters in [0, best t]; any hit at tmax 4, one chunk per occluded lane
    and the chunks the others enter in [0, 4)."""
    _, jd, o, d = _case(name)
    td = _dense_t(jd)
    phi = tint.ray_features_t(_v3t(o), _v3t(d))
    if query == "closest":
        bt, _ = ik.closest_hit_ref(td.coeffs, phi, 1e30, td.chunk_bounds)
        bound, occ = torch.where(torch.isfinite(bt), bt, 1e30), None
    else:
        bound = torch.full((o.shape[0],), 4.0)
        occ = ik.any_hit_ref(td.coeffs, phi, 4.0, td.chunk_bounds)
    cb = td.chunk_bounds.numpy()
    chunk_t = td.coeffs.shape[1] // cb.shape[0]
    want = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        for lane in range(o.shape[0]):
            if occ is not None and occ[lane]:
                want += chunk_t
                continue
            for box in cb:
                if box[0] > box[3]:
                    continue
                tmin, tmx, inside = np.float32(0), np.float32(bound[lane]), True
                for k in range(3):
                    if d[lane, k] == 0:
                        inside &= bool(box[k] <= o[lane, k] <= box[3 + k])
                        continue
                    inv = np.float32(1) / d[lane, k]
                    t0 = (box[k] - o[lane, k]) * inv
                    t1 = (box[3 + k] - o[lane, k]) * inv
                    tmin = max(tmin, min(t0, t1))
                    tmx = min(tmx, max(t0, t1))
                enters = tmin <= tmx and (occ is None or tmin < bound[lane])
                want += chunk_t * bool(inside and enters)
    got = kc.needed_tests(phi, bound, td.chunk_bounds, chunk_t, occ)
    assert 0 < got == want < o.shape[0] * td.coeffs.shape[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(name, variant, cuda_device):
    kw = VARIANTS[variant][2]
    _, jd, o, d = _case(name)
    td = _dense_t(jd).to(cuda_device)
    phi = tint.ray_features_t(_v3t(o).to(cuda_device),
                              _v3t(d).to(cuda_device))
    n = phi.shape[1]
    tmaxes = torch.as_tensor(
        np.where(np.arange(n) % 3 == 0, 0.0, 4.0).astype(np.float32),
        device=cuda_device)
    name_c = "closest_hit_streamed" if kw["stream"] else "closest_hit"
    name_a = "any_hit_streamed" if kw["stream"] else "any_hit"
    for tmax in (torch.full((n,), 1e30, device=cuda_device), tmaxes):
        before = (cuda_lib.launches[name_c], cuda_lib.launches[name_a])
        bt, bi = ik.closest_hit(td.coeffs, phi, tmax, td.chunk_bounds, **kw)
        rt, ri = ik.closest_hit_ref(td.coeffs, phi, tmax, td.chunk_bounds)
        hk = ik.any_hit(td.coeffs, phi, tmax, td.chunk_bounds, **kw)
        hr = ik.any_hit_ref(td.coeffs, phi, tmax, td.chunk_bounds)
        torch.cuda.synchronize()
        assert (cuda_lib.launches[name_c], cuda_lib.launches[name_a]) == (
            before[0] + 1, before[1] + 1)
        edge, tie = kc.boundary_lanes(td.coeffs, phi, tmax, td.chunk_bounds)
        keep = ~edge
        assert torch.equal(torch.isfinite(bt)[keep], torch.isfinite(rt)[keep])
        assert torch.equal(hk[keep], hr[keep])
        both = keep & torch.isfinite(bt) & torch.isfinite(rt)
        torch.testing.assert_close(bt[both], rt[both], rtol=1e-5, atol=0)
        same = both & ~tie
        assert torch.equal(bi[same], ri[same])


def _sub5_case(device):
    """subdivide(cornell_like, 5) (22,528 triangles, 88 chunks) at 64x64:
    first-bounce rays."""
    import tracer_tpu_torch as T
    from tracer_tpu_torch.utils import testscenes as ts
    tris, tm, mats = ts.cornell_like()
    tris, tm = ts.subdivide(tris, tm, levels=5)
    s = T.init(0, 64, 64, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8),
               device=device)
    _, (bo, bd), _ = kc.render_rays(s)
    return s.scene.accel, tint.ray_features_t(bo, bd)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["random5_max_sched3", "sub5_streamed"])
def test_streamed_closest_matches_plain_on_card(case, cuda_device):
    """K2 (warp-granular cull, triangle-major stage) against the plain
    version: hits and best t within rtol 1e-5, best_i outside ties; its
    stats within the plain model's bracket (kernel_cases.cull_pairs)."""
    if case == "random5_max_sched3":
        _, jd, o, d = _case("chunks5")
        td = _dense_t(jd).to(cuda_device)
        co, cb = td.coeffs, td.chunk_bounds
        phi = tint.ray_features_t(_v3t(o).to(cuda_device),
                                  _v3t(d).to(cuda_device))
        max_sched = 3
    else:
        dense, phi = _sub5_case(cuda_device)
        co, cb, max_sched = dense.coeffs, dense.chunk_bounds, ik.MAX_SCHED
    hi = torch.as_tensor(1e30, dtype=torch.float32, device=cuda_device)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    before = cuda_lib.launches["closest_hit_streamed"]
    bt, bi = ik.closest_hit(co, phi, hi, cb, stream=True,
                            max_sched=max_sched, stats=stats)
    rt, ri = ik.closest_hit_ref(co, phi, hi, cb)
    torch.cuda.synchronize()
    assert cuda_lib.launches["closest_hit_streamed"] == before + 1
    edge, tie = kc.boundary_lanes(co, phi, hi, cb)
    keep = ~edge
    assert torch.equal(torch.isfinite(bt)[keep], torch.isfinite(rt)[keep])
    both = keep & torch.isfinite(bt) & torch.isfinite(rt)
    torch.testing.assert_close(bt[both], rt[both], rtol=1e-5, atol=0)
    assert torch.equal(bi[both & ~tie], ri[both & ~tie])
    block = ik.STREAMED_CLOSEST_BLOCK
    g, _, order, count = ik.walk_schedule(phi, hi, cb, max_sched, block)
    least = kc.cull_pairs(phi, torch.minimum(bt, hi), cb, g, order, count,
                          block)
    most = kc.cull_pairs(phi, hi.expand(bt.shape), cb, g, order, count,
                         block)
    assert int(least.sum()) <= int(stats[1]) <= int(most.sum())
    assert 0 < int(stats[0]) <= order.shape[0] * cb.shape[0]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["random5_max_sched3", "sub5_streamed"])
def test_streamed_any_matches_plain_on_card(case, cuda_device):
    """K4 (warp-granular cull, triangle-major stage, a stopping walk)
    against the plain version outside the boundary band, against the exact
    kernel's hits on every lane, and its stats within the plain model's bracket
    (kernel_cases.cull_pairs at unstopped_bound and at tmax); K3 gives
    the same hits and takes no stats."""
    if case == "random5_max_sched3":
        _, jd, o, d = _case("chunks5")
        td = _dense_t(jd).to(cuda_device)
        co, cb = td.coeffs, td.chunk_bounds
        phi = tint.ray_features_t(_v3t(o).to(cuda_device),
                                  _v3t(d).to(cuda_device))
        max_sched = 3
    else:
        dense, phi = _sub5_case(cuda_device)
        co, cb, max_sched = dense.coeffs, dense.chunk_bounds, ik.MAX_SCHED
    n = phi.shape[1]
    tmax = torch.as_tensor(
        np.where(np.arange(n) % 3 == 0, 0.0,
                 np.where(np.arange(n) % 3 == 1, 0.5, 4.0)).astype(np.float32),
        device=cuda_device)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    before = cuda_lib.launches["any_hit_streamed"]
    hit = ik.any_hit(co, phi, tmax, cb, stream=True, max_sched=max_sched,
                     stats=stats)
    ref = ik.any_hit_ref(co, phi, tmax, cb)
    bt, _ = ik.closest_hit_exact(co, phi, tmax, cb, max_sched=max_sched)
    torch.cuda.synchronize()
    assert cuda_lib.launches["any_hit_streamed"] == before + 1
    edge, _ = kc.boundary_lanes(co, phi, tmax, cb)
    assert torch.equal(hit[~edge], ref[~edge])
    assert torch.equal(hit, torch.isfinite(bt))
    assert 0 < int(hit.sum()) < n and not bool(hit[tmax <= 0].any())
    block = ik.STREAMED_ANY_BLOCK
    g, _, order, count = ik.walk_schedule(phi, tmax, cb, max_sched, block)
    least = kc.cull_pairs(phi, kc.unstopped_bound(tmax, hit), cb, g, order,
                          count, block)
    most = kc.cull_pairs(phi, tmax, cb, g, order, count, block)
    assert int(least.sum()) <= int(stats[1]) <= int(most.sum())
    assert 0 < int(stats[0]) <= order.shape[0] * cb.shape[0]
    assert torch.equal(ik.any_hit(co, phi, tmax, cb, stream=False,
                                  max_sched=max_sched), hit)
    with pytest.raises(ValueError):
        ik.any_hit(co, phi, tmax, cb, stream=False, stats=stats)


def _mixed_tmax(n, device):
    """Live (1e30 and 4), dead (0) and NaN lanes scattered through every
    warp."""
    i = np.arange(n)
    t = np.where(i % 5 == 1, 0.0, np.where(i % 7 == 3, np.nan,
                                           np.where(i % 3 == 0, 4.0, 1e30)))
    return torch.as_tensor(t.astype(np.float32), device=device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["cornell_one_chunk", "random5",
                                  "random5_max_sched3", "sub5_resident",
                                  "ragged_tail"])
def test_k1_matches_exact_kernel_on_card(case, cuda_device):
    """K1 (warp-granular cull, triangle-major stage, divide for
    candidates, tiles longest schedule first) against the exact yardstick
    kernel on every lane: best_t bit for bit and, both walking 256-lane
    tiles, best_i too; under a scalar tmax and under a per-lane tmax with
    dead (0) and NaN lanes, which give (+inf, 0). cornell_one_chunk has no
    schedule (tiles is null); ragged_tail has 1 and 257 lanes, the last
    block mostly past N."""
    max_sched = ik.MAX_SCHED
    if case == "cornell_one_chunk":
        import tracer_tpu_torch as T
        from tracer_tpu_torch.utils import testscenes as ts
        s = T.init(0, 48, 40, 0, *ts.cornell_like(),
                   cam_origin=(0.0, 0.8, 1.8), device=cuda_device)
        _, (bo, bd), _ = kc.render_rays(s)
        dense, phi = s.scene.accel, tint.ray_features_t(bo, bd)
        co, cb = dense.coeffs, dense.chunk_bounds
        assert cb.shape[0] == 1
        assert ik.walk_operands("closest_hit", phi, 1e30, cb)[2:] == (
            None, None, None)
    elif case == "sub5_resident":
        dense, phi = _sub5_case(cuda_device)
        co, cb = dense.coeffs, dense.chunk_bounds
    else:
        _, jd, o, d = _case("chunks5")
        td = _dense_t(jd).to(cuda_device)
        co, cb = td.coeffs, td.chunk_bounds
        phi = tint.ray_features_t(_v3t(o).to(cuda_device),
                                  _v3t(d).to(cuda_device))
        if case == "random5_max_sched3":
            max_sched = 3
    sets = [phi]
    if case == "ragged_tail":
        sets = [phi[:, :1].contiguous(), phi[:, :257].contiguous()]
    assert ik.BLOCK == ik.EXACT_BLOCK
    for p in sets:
        n = p.shape[1]
        mixed = _mixed_tmax(n, cuda_device)
        for tmax in (torch.full((n,), 1e30, device=cuda_device), mixed):
            before = (cuda_lib.launches["closest_hit"], cuda_lib.launches[ik.EXACT])
            bt, bi = ik.closest_hit(co, p, tmax, cb, stream=False,
                                    max_sched=max_sched)
            et, ei = ik.closest_hit_exact(co, p, tmax, cb,
                                          max_sched=max_sched)
            rt, _ = ik.closest_hit_ref(co, p, tmax, cb)
            torch.cuda.synchronize()
            assert (cuda_lib.launches["closest_hit"], cuda_lib.launches[ik.EXACT]) == (
                before[0] + 1, before[1] + 1)
            assert torch.equal(bt.view(torch.int32), et.view(torch.int32))
            assert torch.equal(bi, ei)
            edge, _ = kc.boundary_lanes(co, p, tmax, cb)
            keep = ~edge
            assert torch.equal(torch.isfinite(bt)[keep],
                               torch.isfinite(rt)[keep])
            both = keep & torch.isfinite(bt) & torch.isfinite(rt)
            torch.testing.assert_close(bt[both], rt[both], rtol=1e-5, atol=0)
        off = ~(mixed > 0)
        assert bool(off.any()) or n == 1
        assert bool(torch.isinf(bt[off]).all()) and not bool(bi[off].any())


@pytest.mark.requires_cuda
def test_dead_blocks_and_sorted_closest_on_card(cuda_device):
    """A closest query whose per-lane tmax leaves whole warps and whole
    blocks dead (the dead lanes first, as closest_hit_phi orders them)
    gives the scalar-tmax result on the live lanes and (+inf, 0) on the
    dead ones, through K1 and K2, sorted by octant or by odmorton."""
    dense, phi = _sub5_case(cuda_device)
    n = phi.shape[1]
    tmax = torch.where(torch.arange(n, device=cuda_device) % 4 == 0, 1e30,
                       0.0).to(torch.float32)
    live = tmax > 0
    for stream in (False, True):
        want_t, _ = ik.closest_hit_exact(dense.coeffs, phi, 1e30,
                                         dense.chunk_bounds)
        for perm in ("off", "oct", "odmorton"):
            bt, bi = tint.closest_hit_phi(dense, tmax, phi, perm=perm,
                                          stream=stream)
            assert torch.equal(bt[live].view(torch.int32),
                               want_t[live].view(torch.int32))
            assert bool(torch.isinf(bt[~live]).all())
            assert not bool(bi[~live].any())
