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


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name, monkeypatch):
    # exact divide in the Pallas kernel; its scores are bf16x3 products
    # (~2^-15 of each term, so t carries up to ~1e-3 where n.s cancels):
    # compare away from the lanes within 1e-3 of a validity boundary
    monkeypatch.setenv("TRACER_APPROX_RECIP", "0")
    _, jd, o, d = _case(name)
    td = _dense_t(jd)
    phi_j = jint.ray_features_t(_v3j(o), _v3j(d))
    phi_t = tint.ray_features_t(_v3t(o), _v3t(d))
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=1e-6)
    bt_j, bi_j = pk.closest_hit_pallas(jd.coeffs, phi_j, 1e30, jd.chunk_bounds,
                                       interpret=True)
    bt, bi = ik.closest_hit(td.coeffs, phi_t, 1e30, td.chunk_bounds)
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
                    td.chunk_bounds).numpy()
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
    ik.reset_counts()
    tint.closest_hit(td, 1e30, _v3t(o), _v3t(d))
    tint.any_hit(td, 4.0, _v3t(o), _v3t(d))
    assert ik.launches == {"closest_hit": 0, "any_hit": 0}
    assert ik.plain_calls == {"closest_hit": 1, "any_hit": 1}
    with pytest.raises(ValueError):
        ik.closest_hit(td.coeffs, torch.zeros((9, 4)), 1.0, td.chunk_bounds)
    with pytest.raises(ValueError):
        ik.any_hit(td.coeffs, torch.zeros((10, 4)), torch.ones(3),
                   td.chunk_bounds)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(name, cuda_device):
    _, jd, o, d = _case(name)
    td = _dense_t(jd).to(cuda_device)
    phi = tint.ray_features_t(_v3t(o).to(cuda_device),
                              _v3t(d).to(cuda_device))
    n = phi.shape[1]
    tmaxes = torch.as_tensor(
        np.where(np.arange(n) % 3 == 0, 0.0, 4.0).astype(np.float32),
        device=cuda_device)
    for tmax in (torch.full((n,), 1e30, device=cuda_device), tmaxes):
        bt, bi = ik.closest_hit(td.coeffs, phi, tmax, td.chunk_bounds)
        rt, ri = ik.closest_hit_ref(td.coeffs, phi, tmax, td.chunk_bounds)
        hk = ik.any_hit(td.coeffs, phi, tmax, td.chunk_bounds)
        hr = ik.any_hit_ref(td.coeffs, phi, tmax, td.chunk_bounds)
        torch.cuda.synchronize()
        edge, tie = kc.boundary_lanes(td.coeffs, phi, tmax, td.chunk_bounds)
        keep = ~edge
        assert torch.equal(torch.isfinite(bt)[keep], torch.isfinite(rt)[keep])
        assert torch.equal(hk[keep], hr[keep])
        both = keep & torch.isfinite(bt) & torch.isfinite(rt)
        torch.testing.assert_close(bt[both], rt[both], rtol=1e-5, atol=0)
        same = both & ~tie
        assert torch.equal(bi[same], ri[same])
