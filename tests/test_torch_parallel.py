"""Port parity: tracer_tpu_torch.parallel.render on torch.distributed.

The ranks are gloo processes on the CPU, spawned by parallel.local once
per world size (one thread each). Their results are held against the
port's single-process render and against the JAX package's shard_map
twin (tracer_tpu.parallel.render) on the conftest's virtual CPU devices,
from the same state (utils/convert.state_from_numpy):
  - a tile-only mesh equals the single-process render bit for bit;
  - a sample axis matches within rtol 1e-5: render_pooled_sharded the
    single render at the same spp (replica si draws samples si * spp_local
    ..), step_sharded the mean of the single 1-spp frames at nonces
    nonce * n_sample + si;
  - against JAX on the (2, 2) mesh, which has both axes and both nonce
    conventions, as tests/test_torch_pooled.py holds the pool: >= 99% of
    pixels within rtol 1e-4 / atol 1e-5 (a tile-only mesh is the single
    render, which that file holds to the JAX pool);
  - points: returns, positions equal and intensity within rtol 1e-6 of
    the port's sample_points_n.
"""

import numpy as np
import jax
import pytest
import torch
import torch.distributed as dist

import tracer_tpu as J
from tracer_tpu.engine import keys as jkeys
from tracer_tpu.parallel import render as jpar
from tracer_tpu.utils import testscenes
import tracer_tpu_torch as T
from tracer_tpu_torch.engine import api as tapi
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.ops import rng as trng
from tracer_tpu_torch.parallel import local
from tracer_tpu_torch.parallel import render as tpar
from tracer_tpu_torch.utils import convert

torch.set_num_threads(2)

SIZE = 32
SPP = 4
STEPS = 2
CAM = (0.0, 0.8, 1.8)
SHAPES = [(2, 1), (4, 1), (1, 2), (2, 2)]
JAX_SHAPE = (2, 2)   # tile and sample axes at once, both nonce conventions
# sensor configs, accumulation on: colour for the render and the steps,
# LiDAR (distance mode) for the capture and the distance steps
STATES = {"color": 0, "lidar": 2}


def _jstate(name):
    js = J.init(0, SIZE, SIZE, STATES[name], *testscenes.cornell_like(),
                cam_origin=CAM)
    return J.key(jkeys.KEYDOWN, jkeys.SDLK_SPACE, js)


@pytest.fixture(scope="module")
def states():
    """{name: (JAX state, the port's state converted from it)}."""
    out = {}
    for name in STATES:
        js = _jstate(name)
        out[name] = (js, convert.state_from_numpy(
            jax.tree.map(np.asarray, js), "cpu"))
    return out


def _calls(shape, states):
    return [("render_pooled_sharded", shape, states["color"][1], SPP),
            ("step_sharded", shape, states["color"][1], STEPS),
            ("sample_points_sharded", shape, states["lidar"][1], SPP),
            ("step_sharded", shape, states["lidar"][1], STEPS)]


KEYS = ("render", "step", "points", "distance_step")


@pytest.fixture(scope="module")
def sharded(states):
    """{(shape, key): rank 0's result}, one spawn per world size."""
    out = {}
    for world in (2, 4):
        shapes = [s for s in SHAPES if s[0] * s[1] == world]
        calls = [c for shape in shapes for c in _calls(shape, states)]
        res = local.run_sharded(world, calls, device="cpu", threads=1)
        for i, r in enumerate(res):
            out[shapes[i // len(KEYS)], KEYS[i % len(KEYS)]] = r
    return out


def _want_steps(s, n_sample, steps):
    """step_sharded's frames on one process: the mean of the 1-spp
    frames at nonces nonce * n_sample + si, merged by api.step's rule."""
    for _ in range(steps):
        w, h = s.sub_dims
        frames = [tint.render_pooled(
            s.seed, (s.nonce * n_sample + si) & trng.MASK, s.scene, s.cam,
            s.ambience, w, h, s.transmitter_kind, 1, s.render_mode)["img"]
            for si in range(n_sample)]
        s = tapi.merge_frame(s, sum(frames) / n_sample)
    return s


def _has(pts):
    return ~((pts[..., :3] == -1).all(-1) & (pts[..., 3] == 0))


def _assert_every_rank_intersected(r, world):
    """Every rank went through the intersect and shading wrappers (here
    on the CPU: their plain versions; on the card the kernels), each
    counted in cuda_lib."""
    calls = r["plain_calls"]
    for k in ("closest_hit", "any_hit", "shade_prepare", "shade_finish"):
        assert all(c > 0 for c in calls[k]), calls
    assert len(calls["closest_hit"]) == world


@pytest.mark.parametrize("shape", SHAPES)
def test_render_pooled_sharded(shape, states, sharded):
    r = sharded[shape, "render"]
    _assert_every_rank_intersected(r, shape[0] * shape[1])
    s = states["color"][1]
    want = tint.render_pooled(s.seed, s.nonce, s.scene, s.cam, s.ambience,
                              SIZE, SIZE, s.transmitter_kind, SPP,
                              s.render_mode)["img"]
    got = r["out"]
    assert got.shape == (SIZE, SIZE, 3) and float(got.max()) > 0.5
    if shape[1] == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("key", ["step", "distance_step"])
@pytest.mark.parametrize("shape", SHAPES)
def test_step_sharded(shape, key, states, sharded):
    r = sharded[shape, key]
    s = states["color" if key == "step" else "lidar"][1]
    assert (r["nonce"], r["n_frames"]) == (s.nonce + STEPS, STEPS)
    if shape[1] == 1:
        want = s
        for _ in range(STEPS):
            want = T.step(want)
        assert torch.equal(r["out"], want.img)
    else:
        want = _want_steps(s, shape[1], STEPS)
        torch.testing.assert_close(r["out"], want.img, rtol=1e-5, atol=0)
    if key == "distance_step":
        assert float(r["out"].min()) >= 0 and float(r["out"].max()) <= 1
        assert float((r["out"].sum(-1) > 0).float().mean()) > 0.5


@pytest.mark.parametrize("shape", SHAPES)
def test_sample_points_sharded(shape, states, sharded):
    r = sharded[shape, "points"]
    _assert_every_rank_intersected(r, shape[0] * shape[1])
    _, want = T.sample_points_n(states["lidar"][1], SPP)
    got = r["out"]
    assert got.shape == (SIZE, SIZE, 4)
    has = _has(got)
    assert torch.equal(has, _has(want)) and float(has.float().mean()) > 0.5
    assert torch.equal(got[~has], want[~has])
    assert torch.equal(got[..., :3], want[..., :3])
    torch.testing.assert_close(got[..., 3], want[..., 3], rtol=1e-6, atol=0)


def _close_share(got, want, rtol, atol):
    ok = np.isclose(got, want, rtol=rtol, atol=atol).all(axis=-1)
    return ok.mean(), np.argwhere(~ok)


@pytest.mark.parametrize("key", ["render", "step", "points"])
def test_matches_jax_sharded(key, states, sharded):
    """The port's (2, 2) mesh against the JAX twin's on four virtual CPU
    devices, from the same state."""
    mesh = jpar.make_mesh(*JAX_SHAPE)
    got = sharded[JAX_SHAPE, key]["out"].numpy()
    if key == "render":
        want = np.asarray(jpar.render_pooled_sharded(states["color"][0],
                                                     mesh, SPP))
    elif key == "step":
        js = states["color"][0]
        for _ in range(STEPS):
            js = jpar.step_sharded(js, mesh)
        want = np.asarray(js.img)
        assert int(js.nonce) == sharded[JAX_SHAPE, key]["nonce"]
    else:
        want = np.asarray(jpar.sample_points_sharded(states["lidar"][0],
                                                     mesh, SPP))
        has = _has(torch.from_numpy(want.copy())).numpy()
        assert has.mean() > 0.5
        share, bad = _close_share(got[..., :3], want[..., :3], 1e-4, 1e-4)
        assert share >= 0.99, bad
        share, bad = _close_share(got[..., 3:], want[..., 3:], 1e-4, 1e-6)
        assert share >= 0.99, bad
        return
    assert want.max() > 0.5
    share, bad = _close_share(got, want, 1e-4, 1e-5)
    assert share >= 0.99, bad


def _tie_inputs(n_sample, n=4):
    """The synthetic replicas of tests/test_parallel.py: pixel 0 ties at
    d = 1 on replicas 2 and 5 with different points, pixel 1 has its
    least distance on replica 3 alone, pixel 2 misses everywhere, pixel
    3 ties on every replica. Replica si reports (si, -si, 10 + si) and
    intensity 100 + si."""
    si = np.arange(n_sample, dtype=np.float32)
    dist_ = np.full((n_sample, n), np.inf, np.float32)
    dist_[:, 0] = np.where(np.isin(si, (2, 5)), 1.0, 2.0)
    dist_[:, 1] = np.where(si == 3, 0.5, 3.0)
    dist_[:, 3] = 7.0
    pos = np.broadcast_to(np.stack([si, -si, 10 + si], axis=1)[..., None],
                          (n_sample, 3, n)).copy()
    inten = np.broadcast_to((100 + si)[:, None], (n_sample, n)).copy()
    return pos, dist_, inten


def test_merge_points_newest_tie_keeps_newest_whole_point():
    n_sample = 8
    (r,) = local.run_sharded(
        n_sample, [("merge_points_newest", (1, n_sample), None,
                    _tie_inputs(n_sample))], device="cpu", threads=1)
    pos, inten, best_d = (r["out"][k].numpy()
                          for k in ("pos", "inten", "best_d"))
    # replicas 2 and 5 tie: replica 5's whole point, not a max per axis
    assert best_d[0] == 1.0 and inten[0] == 105.0
    np.testing.assert_array_equal(pos[:, 0], [5.0, -5.0, 15.0])
    assert best_d[1] == 0.5 and inten[1] == 103.0
    np.testing.assert_array_equal(pos[:, 1], [3.0, -3.0, 13.0])
    assert np.isinf(best_d[2])
    # every replica ties: the newest (7)
    np.testing.assert_array_equal(pos[:, 3], [7.0, -7.0, 17.0])
    assert inten[3] == 107.0


@pytest.mark.parametrize("fn,axes,match", [
    ("render_pooled_sharded", (3, 1), "height"),
    ("render_pooled_sharded", (1, 3), "spp"),
    ("sample_points_sharded", (3, 1), "height"),
    ("sample_points_sharded", (1, 3), "spp"),
    ("step_sharded", (3, 1), "height")])
def test_axes_must_divide(fn, axes, match, states):
    """h and spp not divisible by the mesh axes raise ValueError before
    any collective (a step renders one sample on each replica)."""
    mesh = tpar.Mesh(None, *axes, 0, 0, None)
    s = states["color"][1]
    args = () if fn == "step_sharded" else (SPP,)
    with pytest.raises(ValueError, match=match):
        getattr(tpar, fn)(s, mesh, *args)


def test_make_mesh_in_one_process(tmp_path, states):
    """Without a process group make_mesh raises; in a world of one rank a
    (2, 1) mesh is too large (ValueError, as the JAX twin raises for too
    few devices) and a (1, 1) mesh renders the single-process image bit
    for bit."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.make_mesh(1, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks, the group has 1"):
            tpar.make_mesh(2, 1)
        mesh = tpar.make_mesh(1, 1)
        assert (mesh.n_tile, mesh.n_sample, mesh.ti, mesh.si) == (1, 1, 0, 0)
        s = states["color"][1]
        got = tpar.render_pooled_sharded(s, mesh, 1)
        assert torch.equal(got, T.sample_n_frames(s, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("call,match", [
    (("render", (1, 1), None, 1), "unknown call"),
    (("render_pooled_sharded", (2, 2), None, 1), "not the world")])
def test_run_sharded_checks_calls(call, match):
    with pytest.raises(ValueError, match=match):
        local.run_sharded(2, [call], device="cpu")
