"""The port against the independent numpy oracle (verify/
ref_estimator_numpy.py, a line-by-line numpy reading of the reference
estimator that shares no estimator code with either package): the twin of
tests/test_ref_estimator.py::test_smoke_micro_energy_parity for
tracer_tpu_torch, through init -> sample_n_frames on the CPU. The oracle
is imported by this test only, never by the port."""

import numpy as np
import pytest
import torch

import tracer_tpu_torch as T
from tracer_tpu_torch.utils import testscenes
from verify.ref_estimator_numpy import render as ref_render

torch.set_num_threads(2)

CAM = (0.0, 0.8, 1.8)


@pytest.fixture(scope="module")
def oracle_mean():
    """The oracle's 16x16, 24-spp mean image of the procedural Cornell
    box."""
    tris, tm, mats = testscenes.cornell_like()
    mean, _, _ = ref_render(0, 16, 16, 24, tris, tm, mats, cam_origin=CAM)
    assert np.isfinite(mean).all()
    return mean


@pytest.mark.parametrize("seed", [0, 1])
def test_micro_energy_parity_with_numpy_oracle(oracle_mean, seed):
    """A 16x16 procedural-Cornell render at 47 spp through the port's
    estimator and the oracle's agree on per-channel energy within 15%
    (generous Monte Carlo noise): a lost emission term or broken
    roulette / NEE wiring moves it by far more."""
    tris, tm, mats = testscenes.cornell_like()
    s = T.init(seed, 16, 16, 0, tris, tm, mats, cam_origin=CAM, device="cpu")
    mean_t = T.sample_n_frames(s, 48).numpy()
    assert mean_t.shape == oracle_mean.shape == (16, 16, 3)
    assert np.isfinite(mean_t).all()
    for c in range(3):
        a, b = oracle_mean[..., c].mean(), mean_t[..., c].mean()
        assert abs(b - a) / max(a, 1e-6) < 0.15, (c, a, b)


def test_prism_against_independent_reference():
    """The port's sample_n_frames on the prism scene (refraction, the
    ref_ix dispersion, caustics) at 32x32 and 256 spp against the
    committed golden of the independent estimator, by verify/compare's
    z statistics at the bounds of tests/test_ref_estimator.py: median |z|
    at the null, and tails no heavier than the same-estimator control
    probe's (x2 slack, 2e-3 floor). Holds the pool's iteration (refill,
    the stores, the sample-order merge) to the reference's semantics."""
    import os
    from verify.compare import zstats
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                  "ref_numpy_prism32.npz"))
    size, spp = int(golden["size"]), 256
    mean, var, n_ref = golden["mean"], golden["var"], int(golden["spp"])
    ctrl = zstats(mean, var, n_ref, golden["mean_ctrl"],
                  int(golden["spp_ctrl"]))
    tris, tm, mats = testscenes.prism_scene()
    s = T.init(0, size, size, 0, tris, tm, mats,
               cam_origin=tuple(golden["origin"]), device="cpu")
    img = T.sample_n_frames(s, spp).numpy()
    assert img.shape == mean.shape and np.isfinite(img).all()
    test = zstats(mean, var, n_ref, img, spp)
    assert 0.55 < test["median_abs"] < 0.85, (test, ctrl)
    assert test["frac_gt5"] < max(2.0 * ctrl["frac_gt5"], 2e-3), (test, ctrl)
