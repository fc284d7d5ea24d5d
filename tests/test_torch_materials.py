"""Port parity: the uber-BSDF of tracer_tpu_torch against the JAX package,
lane for lane on the Cornell and prism materials. RNG states are exact;
values agree within rtol 1e-5 (transcendentals differ by ulps between
XLA's and torch's CPU kernels)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tracer_tpu.ops import materials as jmat
from tracer_tpu.utils import testscenes
from tracer_tpu_torch.ops import materials as tmat

torch.set_num_threads(2)

N = 2048
RTOL, ATOL = 1e-5, 1e-5


def _unit(r, n):
    v = r.normal(size=(3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0)


def _inputs(scene_fn, seed):
    r = np.random.default_rng(seed)
    _, _, mats = scene_fn()
    ix = r.integers(0, mats.shape[0], N)
    rows_t = np.ascontiguousarray(mats[ix].T)          # (28, N)
    wavelen = r.uniform(380.0, 720.0, N).astype(np.float32)
    normal = _unit(r, N)
    wo = _unit(r, N)
    wi = _unit(r, N)
    # half the directions on the normal's side, as at a real hit
    flip = np.sign(np.sum(wo * normal, 0))
    wo[:, ::2] *= flip[::2]
    state = r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    return rows_t, wavelen, normal, wo, wi, state


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


SCENES = {"cornell": testscenes.cornell_like, "prism": testscenes.prism_scene}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_bsdf_eval_lane_for_lane(scene):
    rows_t, wl, normal, wo, wi, _ = _inputs(SCENES[scene], 5)
    jm, jem = jmat.at_wavelength_rows(jnp.asarray(rows_t), jnp.asarray(wl))
    tm, tem = tmat.at_wavelength_rows(torch.as_tensor(rows_t),
                                      torch.as_tensor(wl))
    _close(jem, tem)
    for a, b in zip(jm, tm):
        _close(a, b)
    args_j = (jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(normal), jm)
    args_t = (torch.as_tensor(wo), torch.as_tensor(wi),
              torch.as_tensor(normal), tm)
    _close(jmat.bsdf_f(*args_j), tmat.bsdf_f(*args_t))
    _close(jmat.bsdf_pdf(*args_j), tmat.bsdf_pdf(*args_t))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_sample_dir_lane_for_lane(scene):
    rows_t, wl, normal, wo, _, state = _inputs(SCENES[scene], 6)
    jm, _ = jmat.at_wavelength_rows(jnp.asarray(rows_t), jnp.asarray(wl))
    tm, _ = tmat.at_wavelength_rows(torch.as_tensor(rows_t),
                                    torch.as_tensor(wl))
    js, jwi, jb, jp, jk = jmat.sample_dir(jnp.asarray(state), jnp.asarray(wo),
                                          jnp.asarray(normal), jm)
    ts, twi, tb, tp, tk = tmat.sample_dir(
        torch.as_tensor(state.astype(np.int64)), torch.as_tensor(wo),
        torch.as_tensor(normal), tm)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    _close(jwi, twi)
    _close(jp, tp)
    # A roughness-0 lobe (the glass prism: Beckmann alpha 0.0065) turns an
    # ulp in the sampled half vector into ~1e-3 of its BSDF value.
    sharp = rows_t[12] < 0.01
    np.testing.assert_allclose(tb.numpy()[~sharp], np.asarray(jb)[~sharp],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb.numpy()[sharp], np.asarray(jb)[sharp],
                               rtol=1e-2)
