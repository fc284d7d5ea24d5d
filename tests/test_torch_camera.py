"""Port parity: camera sampling of tracer_tpu_torch against the JAX package.
RNG states and channels are exact; wavelengths and rays agree within
rtol 1e-5 (torch.special.ndtri and XLA's ndtri differ by ulps)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer_tpu.models import camera as jcam, sensors as jsensors
from tracer_tpu_torch.models import camera as tcam
from tracer_tpu_torch.utils import convert

torch.set_num_threads(2)

N = 4096


def _cams(conf_id, pitch=0.1, yaw=-0.3, origin=(0.0, 0.8, 1.8), aperture=None):
    conf = jsensors.conf_for_id(conf_id)[0]
    if aperture is not None:
        conf = conf._replace(aperture=jnp.float32(aperture))
    jc = jcam.Camera(pitch=jnp.float32(pitch), yaw=jnp.float32(yaw),
                     origin=jnp.asarray(origin, jnp.float32), conf=conf)
    tc = convert.camera_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    return jc, tc


def _states(seed):
    r = np.random.default_rng(seed)
    return r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("conf_id", [0, 2])
def test_sample_wavelength(conf_id):
    jc, tc = _cams(conf_id)
    s = _states(conf_id)
    js, jwl, jch = jcam.sample_wavelength(jnp.asarray(s), jc.conf)
    ts, twl, tch = tcam.sample_wavelength(torch.as_tensor(s.astype(np.int64)),
                                          tc.conf)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))
    np.testing.assert_allclose(twl.numpy(), np.asarray(jwl), rtol=1e-5)


@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_sample_ray(aperture):
    jc, tc = _cams(0, aperture=aperture)
    w, h = 64, 64
    s = _states(3)
    lane = np.arange(N)
    jx = (lane % w).astype(np.float32)
    iy = (h - lane // w - 1).astype(np.float32)
    js, jo, jd = jcam.sample_ray(jnp.asarray(s), jc,
                                 (jnp.float32(w), jnp.float32(h)),
                                 jnp.asarray(jx), jnp.asarray(iy))
    ts, to, td = tcam.sample_ray(torch.as_tensor(s.astype(np.int64)), tc,
                                 (w, h), torch.as_tensor(jx),
                                 torch.as_tensor(iy))
    np.testing.assert_array_equal(ts.numpy(), s.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(js), s)
    np.testing.assert_allclose(to.expand(3, N).numpy(),
                               np.broadcast_to(np.asarray(jo), (3, N)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
