"""Port parity: the public API of tracer_tpu_torch against the JAX package:
init, step / render / step_render, the EMA first-frame quirk, key and
resize; and that importing the port pulls in no JAX."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tracer_tpu as J
from tracer_tpu.engine import keys
from tracer_tpu.utils import testscenes
import tracer_tpu_torch as T
from tracer_tpu_torch.utils import convert

torch.set_num_threads(2)

ORIGIN = (0.0, 0.8, 1.8)


def _scene(name):
    tris, tm, mats = testscenes.cornell_like()
    if name == "cornell_sub4":  # 5,632 triangles, 22 chunks
        tris, tm = testscenes.subdivide(tris, tm, levels=4)
    return tris, tm, mats


def _pair(h=8, w=8, conf=0, scene="cornell"):
    tris, tm, mats = _scene(scene)
    js = J.init(0, h, w, conf, tris, tm, mats, cam_origin=ORIGIN)
    ts = T.init(0, h, w, conf, tris, tm, mats, cam_origin=ORIGIN,
                device="cpu")
    return js, ts


def _conv(js):
    return convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")


def _assert_states_close(a, b):
    """Every field of two port states agrees: statics and counters
    exactly, perm exactly, tensors to rtol 1e-6."""
    for f in ("width", "height", "subsampling", "render_mode",
              "transmitter_kind", "cam_conf_id", "seed", "nonce", "n_frames",
              "mode"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.scene.accel.perm.numpy(),
                                  b.scene.accel.perm.numpy())
    sa = dict(a.scene.named_buffers())
    sb = dict(b.scene.named_buffers())
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_allclose(sa[k].numpy(), sb[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for x, y in [(a.img, b.img), (a.ambience, b.ambience),
                 (a.cam.pitch, b.cam.pitch), (a.cam.yaw, b.cam.yaw),
                 (a.cam.origin, b.cam.origin), *zip(a.cam.conf, b.cam.conf)]:
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("conf, scene", [(0, "cornell"), (1, "cornell"),
                                         (2, "cornell"), (0, "cornell_sub4")])
def test_init_matches_converted_jax_state(conf, scene):
    js, ts = _pair(conf=conf, scene=scene)
    _assert_states_close(ts, _conv(js))


def test_step_and_render_argb():
    js, ts = _pair()
    js, ts = js.replace(mode=jnp.asarray(True)), T.key(
        keys.KEYDOWN, keys.SDLK_m, ts)
    for _ in range(3):
        js, jargb = J.step_render(js)
        ts, targb = T.step_render(ts)
        assert targb.dtype == torch.uint32 and targb.shape == (8, 8)
        same = targb.numpy() == np.asarray(jargb)
        assert same.mean() >= 0.99
    assert ts.nonce == int(js.nonce) and ts.n_frames == int(js.n_frames)
    np.testing.assert_array_equal(T.render(ts).numpy(), targb.numpy())


def test_accumulation_ema_first_frame_quirk():
    """The n_frames=1 merge discards the first frame."""
    _, s = _pair()
    s = T.key(keys.KEYDOWN, keys.SDLK_m, s)
    s1 = T.step(s)
    s2 = T.step(s1)
    assert s2.n_frames == 2
    from dataclasses import replace
    lone = T.step(replace(s, nonce=s1.nonce))
    np.testing.assert_allclose(s2.img.numpy(), lone.img.numpy(), rtol=1e-5,
                               atol=1e-6)


_KEYS = [keys.SDLK_w, keys.SDLK_a, keys.SDLK_x, keys.SDLK_UP,
         keys.SDLK_RIGHT, keys.SDLK_2, keys.SDLK_2, keys.SDLK_1,
         keys.SDLK_SPACE, keys.SDLK_n, keys.SDLK_m, keys.SDLK_i, keys.SDLK_k,
         keys.SDLK_k, keys.SDLK_o, keys.SDLK_l, keys.SDLK_p, keys.SDLK_p,
         keys.SDLK_p, keys.SDLK_t, keys.SDLK_t, keys.SDLK_t, keys.SDLK_q]


def test_key_and_resize_parity():
    js, ts = _pair()
    js = J.step(js)
    ts = T.step(ts)
    for code in _KEYS:
        js = J.key(keys.KEYDOWN, code, js)
        ts = T.key(keys.KEYDOWN, code, ts)
        a, b = ts, _conv(js)
        for f in ("subsampling", "mode", "n_frames", "cam_conf_id",
                  "render_mode", "transmitter_kind"):
            assert getattr(a, f) == getattr(b, f), (code, f)
        for x, y in [(a.cam.pitch, b.cam.pitch), (a.cam.yaw, b.cam.yaw),
                     (a.cam.origin, b.cam.origin), (a.ambience, b.ambience),
                     *zip(a.cam.conf, b.cam.conf)]:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=str(code))
    assert T.key(keys.KEYUP, keys.SDLK_w, ts) is ts
    js = J.resize(6, 10, js)
    ts = T.resize(6, 10, ts)
    b = _conv(js)
    assert (ts.width, ts.height, ts.mode, tuple(ts.img.shape)) == (
        b.width, b.height, b.mode, tuple(b.img.shape))


def test_cycled_config_renders_raise():
    """'t' cycles to the flash (1) and LiDAR (2) configs, whose frames now
    render as the JAX package's do; the LBVH accel builds through init,
    and an unknown accel raises."""
    js, ts = _pair()
    for conf, kind, mode in ((1, "flash", "color"),
                             (2, "scanning", "distance")):
        js = J.key(keys.KEYDOWN, keys.SDLK_t, js)
        ts = T.key(keys.KEYDOWN, keys.SDLK_t, ts)
        assert (ts.cam_conf_id, ts.transmitter_kind, ts.render_mode) == (
            conf, kind, mode)
        js, ts = J.step(js), T.step(ts)
        px_ok = np.isclose(ts.img.numpy(), np.asarray(js.img), rtol=1e-4,
                           atol=1e-5).all(axis=-1)
        assert px_ok.mean() >= 0.99 and float(ts.img.max()) > 0
    tris, tm, mats = _scene("cornell")
    from tracer_tpu_torch.ops import bvh as tbvh
    lb = T.init(0, 8, 8, 0, tris, tm, mats, accel="lbvh", device="cpu")
    assert isinstance(lb.scene.accel, tbvh.LBVH)
    with pytest.raises(ValueError, match="unknown accel"):
        T.init(0, 8, 8, 0, tris, tm, mats, accel="grid", device="cpu")


def test_import_pulls_in_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, tracer_tpu_torch as T; "
            "from tracer_tpu_torch.engine import api; "
            "from tracer_tpu_torch.utils import convert, kernel_cases, "
            "image, measure_recip, objloader, pcd, testscenes; "
            "from tracer_tpu_torch.frontends import save_demo; "
            "from tracer_tpu_torch.ops import recip; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'tracer_tpu' not in sys.modules, 'tracer_tpu imported'")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
