"""The port's exported step (tracer_tpu_torch/utils/aot.py) against
api.step and against the JAX package's exported step, and the pieces that
make the step exportable: the intersection kernels as custom ops, the
tensor seed of the RNG, the while_loop form of the pool and of the
LBVH walk, and the tensor form of the colour merge. On the CPU the ops
run their plain versions; the card tests (requires_cuda) launch the
kernels."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu_torch as T
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.ops import bvh as tbvh
from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.ops import intersect as tisect
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.ops import loop
from tracer_tpu_torch.ops import rng as trng
from tracer_tpu_torch.utils import aot, checkpoint, convert, testscenes

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORIGIN = (0.0, 0.8, 1.8)
H, W = 10, 12
# the states of one artifact each: (sensor config, accel)
KINDS = {"color": (0, "auto"), "distance": (2, "auto"), "lbvh": (0, "lbvh")}


def _accumulating(seed, conf, accel, scene=None, h=H, w=W, device="cpu",
                  **cam):
    """A state with accumulation on and one frame, as the viewer leaves
    it after SPACE and a step."""
    tris, tm, mats = scene or testscenes.cornell_like()
    s = T.init(seed, h, w, conf, tris, tm, mats, accel=accel,
               device=device, **{"cam_origin": ORIGIN, **cam})
    return T.step(dataclasses.replace(s, mode=True))


@pytest.fixture(scope="module")
def artifact():
    """kind -> (state, artifact bytes, loaded step); one export per kind
    of state, made at first use."""
    made = {}

    def get(kind):
        if kind not in made:
            s = _accumulating(3, *KINDS[kind])
            blob = aot.export_step(s)
            made[kind] = (s, blob, aot.load(blob))
        return made[kind]
    return get


def _steps_equal(step, s, n=3):
    """step and api.step from s, n times: images bit for bit, counters
    equal."""
    a = b = s
    for _ in range(n):
        a, b = step(a), T.step(b)
        assert isinstance(a.n_frames, int) and isinstance(a.nonce, int)
        assert (a.n_frames, a.nonce) == (b.n_frames, b.nonce)
        assert a.img.device == b.img.device
        assert torch.equal(a.img, b.img)
    return a


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_loaded_step_equals_api_step(artifact, kind):
    """Three accumulating steps of the loaded artifact give api.step's
    images and counters bit for bit: colour (config 0), distance
    (config 2, the scanning fan) and the LBVH accel (the walk's
    while_loop inside the pool's)."""
    s, blob, step = artifact(kind)
    assert isinstance(step, aot.LoadedStep)
    assert s.n_frames == 1 and s.mode
    last = _steps_equal(step, s)
    assert last.n_frames == 4 and float(last.img.max()) > 0


def test_one_artifact_steps_another_state(artifact):
    """The scene, the camera, the counters and the image are inputs of
    the program: an artifact steps a state of another seed, camera and
    scene of the same triangle count exactly as api.step does."""
    s, _, step = artifact("color")
    tris, tm, mats = testscenes.cornell_like()
    moved = (tris * np.float32(1.1) + np.float32(0.05)).astype(np.float32)
    other = _accumulating(7, 0, "auto", scene=(moved, tm, mats),
                          cam_pitch=0.05, cam_yaw=-0.1,
                          cam_origin=(0.05, 0.9, 2.0))
    for k in ("img", "scene.accel.coeffs"):
        assert aot._leaves(other)[k].shape == aot._leaves(s)[k].shape
    assert not torch.equal(other.scene.accel.coeffs, s.scene.accel.coeffs)
    _steps_equal(step, other)
    # a state handed back by the artifact goes in again
    again = step(step(s))
    assert torch.equal(again.img, T.step(T.step(s)).img)


def test_other_shapes_and_fields_refused(artifact):
    """A state of another size, subsampling, accel kind or triangle
    count is refused with a ValueError that names what differs."""
    s, _, step = artifact("color")
    wider = _accumulating(3, 0, "auto", w=W + 2)
    with pytest.raises(ValueError, match="width=12"):
        step(wider)
    with pytest.raises(ValueError, match="subsampling"):
        step(dataclasses.replace(s, subsampling=2))
    lbvh = _accumulating(3, 0, "lbvh")
    with pytest.raises(ValueError, match="accel='dense'"):
        step(lbvh)
    distance = _accumulating(3, 2, "auto")
    with pytest.raises(ValueError, match="render_mode=.color."):
        step(distance)
    tris, tm, mats = testscenes.cornell_like()
    more = _accumulating(3, 0, "auto", scene=(tris[:-2], tm[:-2], mats))
    with pytest.raises(ValueError, match=r"scene\.\S+ of shape"):
        step(more)


def test_standalone_process(artifact, tmp_path):
    """Checkpoint + artifact: a fresh process that builds no scene and
    never imports engine.integrator or engine.api restores the state and
    steps it to api.step's image bit for bit (the twin of
    tests/test_utils.py::test_aot_standalone_process)."""
    s, blob, _ = artifact("color")
    ck, art = tmp_path / "state.npz", tmp_path / "step.pt2"
    out = tmp_path / "img.npy"
    checkpoint.save(str(ck), s)
    art.write_bytes(blob)
    child = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
torch.set_num_threads(1)
from tracer_tpu_torch.utils import aot, checkpoint
state = checkpoint.load({str(ck)!r}, device="cpu")
new = aot.load_step({str(art)!r})(state)
np.save({str(out)!r}, new.img.numpy())
print("COUNTERS", new.n_frames, new.nonce)
print("MODULES", "tracer_tpu_torch.engine.integrator" in sys.modules,
      "tracer_tpu_torch.engine.api" in sys.modules, "jax" in sys.modules)
"""
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = T.step(s)
    assert f"COUNTERS {want.n_frames} {want.nonce}" in proc.stdout
    assert "MODULES False False False" in proc.stdout, proc.stdout
    np.testing.assert_array_equal(np.load(out), want.img.numpy())


def test_loaded_step_agrees_with_jax_artifact(artifact):
    """The port's artifact on a state converted from JAX
    (utils/convert.state_from_numpy) against the JAX package's exported
    step (tracer_tpu/utils/aot.py) on the same state: at the tolerance
    of the API's parity tests, rtol 1e-4, atol 1e-5, on >= 99% of
    pixels, over two accumulating steps."""
    # imported here, not at the top: the JAX package's engine needs flax,
    # which the machine with the card lacks, and the card tests of this
    # file run there
    import tracer_tpu as J
    from tracer_tpu.utils import aot as jaot
    from tracer_tpu.utils import testscenes as jscenes
    _, _, step = artifact("color")
    tris, tm, mats = jscenes.cornell_like()
    js = J.init(3, H, W, 0, tris, tm, mats, cam_origin=ORIGIN)
    js = J.step(js.replace(mode=jnp.asarray(True)))
    jstep = jaot.load(jaot.export_step(js))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for _ in range(2):
        js, ts = jstep(js), step(ts)
        assert (ts.n_frames, ts.nonce) == (int(js.n_frames), int(js.nonce))
        img_j = np.asarray(js.img)
        px_ok = np.isclose(ts.img.numpy(), img_j, rtol=1e-4,
                           atol=1e-5).all(axis=-1)
        assert px_ok.mean() >= 0.99, np.argwhere(~px_ok)
        assert img_j.max() > 0.1


# ---------------------------------------------------------------------------
# the pieces

def test_tensor_seed_streams_equal_int_seed():
    """make_streams_per_lane takes the seed as a 0-d int64 tensor (what
    the exported step passes) and gives the int seed's words bit for
    bit."""
    r = np.random.default_rng(5)
    frames = torch.as_tensor(r.integers(0, 2 ** 32, 1000, dtype=np.int64))
    lanes = torch.as_tensor(r.integers(0, 2 ** 32, 1000, dtype=np.int64))
    for seed in (0, 1, 2 ** 31, 2 ** 32 - 1, 0xDEADBEEF, 12345):
        want = trng.make_streams_per_lane(seed, frames, lanes)
        got = trng.make_streams_per_lane(
            torch.tensor(seed, dtype=torch.int64), frames, lanes)
        assert got.dtype == want.dtype == torch.int64
        assert torch.equal(got, want)


@pytest.fixture
def traced_loop(monkeypatch):
    """ops/loop.run as a traced program runs it: torch's while_loop
    operator, its cond read before every step (its eager implementation,
    the one a loaded artifact calls)."""
    from torch._higher_order_ops.while_loop import while_loop_op
    calls = []

    def run(cond, body, carry):
        calls.append(1)
        return while_loop_op(cond, body, tuple(carry), ())
    monkeypatch.setattr(loop, "_traced", lambda: True)
    monkeypatch.setattr(loop, "_while_loop", run)
    return calls


@pytest.mark.parametrize("conf,accel", [(0, "auto"), (2, "lbvh")])
def test_pool_while_loop_equals_eager(conf, accel, request):
    """render_pooled's pool (and the LBVH walk inside it) under the
    while_loop gives the eager loop's rays_traced, iterations,
    image and points exactly, over a run of several rounds of refill."""
    s = _accumulating(3, conf, accel)
    args = (s.seed, s.nonce, s.scene, s.cam, s.ambience, W, H,
            s.transmitter_kind, 3, s.render_mode)
    want = tint.render_pooled(*args, with_points=True)
    calls = request.getfixturevalue("traced_loop")
    got = tint.render_pooled(*args, with_points=True)
    assert len(calls) >= (2 if accel == "lbvh" else 1)
    assert (got["rays_traced"], got["iters"]) == (want["rays_traced"],
                                                  want["iters"])
    assert torch.equal(got["img"], want["img"])
    for a, b in zip(got["points"], want["points"]):
        assert torch.equal(a, b)


def test_lbvh_walk_while_loop_equals_eager(request):
    """The LBVH walk under while_loop, which stops on the step
    after the last live lane, equals the eager walk, which tests every
    CHECK_EVERY-th step: a step past the last live lane changes
    nothing."""
    tris, _, _ = testscenes.cornell_like()
    bvh = tbvh.build(torch.as_tensor(tris))
    r = np.random.default_rng(2)
    o = torch.as_tensor(r.uniform(-0.8, 0.8, (3, 257)).astype(np.float32))
    o[1] += 1.0
    d = torch.as_tensor(r.normal(size=(3, 257)).astype(np.float32))
    d = d / d.norm(dim=0, keepdim=True)
    tmax = torch.as_tensor(r.uniform(0.0, 3.0, 257).astype(np.float32))
    want = (tbvh.closest_hit(bvh, tmax, o, d), tbvh.any_hit(bvh, tmax, o, d))
    calls = request.getfixturevalue("traced_loop")
    got = (tbvh.closest_hit(bvh, tmax, o, d), tbvh.any_hit(bvh, tmax, o, d))
    assert len(calls) == 2
    for a, b in zip(got[0] + (got[1],), want[0] + (want[1],)):
        assert torch.equal(a, b)
    assert 0 < int(want[1].sum()) < 257


def test_exported_step_holds_the_shade_ops(artifact):
    """The exported step's graph, its while_loop bodies included, calls
    tracer_tpu_torch::shade_prepare and shade_finish (the pool's bounce),
    tracer_tpu_torch::refill (the pool's refill) and
    tracer_tpu_torch::interaction (the closest hit's interaction) beside
    the intersection ops."""
    _, _, step = artifact("distance")
    targets = {str(node.target) for m in step.program.modules()
               if isinstance(m, torch.fx.GraphModule)
               for node in m.graph.nodes if node.op == "call_function"}
    for op in ("shade_prepare", "shade_finish", "refill", "interaction",
               "closest_hit", "any_hit"):
        assert f"tracer_tpu_torch.{op}.default" in targets, op


def test_exported_lbvh_step_holds_the_walk_ops(artifact):
    """The exported step of an LBVH state calls the walk's ops,
    tracer_tpu_torch::lbvh_closest_hit and lbvh_any_hit (and after the
    first, tracer_tpu_torch::interaction), and holds one
    while_loop alone, the pool's: the walk is no loop of the graph."""
    _, _, step = artifact("lbvh")
    nodes = [node for m in step.program.modules()
             if isinstance(m, torch.fx.GraphModule)
             for node in m.graph.nodes if node.op == "call_function"]
    targets = {str(node.target) for node in nodes}
    for op in ("lbvh_closest_hit", "lbvh_any_hit", "shade_prepare",
               "refill", "interaction"):
        assert f"tracer_tpu_torch.{op}.default" in targets, op
    assert sum("while_loop" in str(node.target) for node in nodes) == 1


def test_exported_step_holds_the_prep_ops(monkeypatch):
    """With every query sorted (resolve_perm forced to odmorton, as "auto"
    does on a card over enough chunks), the exported step of a 3-chunk
    scene holds the sorted query's preparation, the ops
    tracer_tpu_torch::lane_key and lane_deal around aten's stable sort,
    and steps bit for bit as api.step does under the same sort."""
    monkeypatch.setattr(tisect, "resolve_perm", lambda *a, **k: "odmorton")
    tris, tm, mats = testscenes.cornell_like()
    tris, tm = testscenes.subdivide(tris, tm, levels=2)
    s = _accumulating(5, 0, "auto", scene=(tris, tm, mats))
    assert s.scene.accel.chunk_bounds.shape[0] == 3
    step = aot.load(aot.export_step(s))
    targets = {str(node.target) for m in step.program.modules()
               if isinstance(m, torch.fx.GraphModule)
               for node in m.graph.nodes if node.op == "call_function"}
    for op in ("tracer_tpu_torch.lane_key.default",
               "tracer_tpu_torch.lane_deal.default", "aten.sort.stable"):
        assert op in targets, op
    cuda_lib.reset_counts()
    _steps_equal(step, s, n=2)
    assert cuda_lib.plain_calls["lane_key"] == cuda_lib.plain_calls[
        "lane_deal"] > 0


def test_custom_ops_fake_shapes_and_cpu_plain():
    """tracer_tpu_torch::closest_hit / any_hit: their fake rules give
    (N,) f32, (N,) int32 and (N,) bool on phi's device; on the CPU they
    are the plain versions, counted in plain_calls and never in
    launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tris, _, _ = testscenes.cornell_like()
    tris, _ = testscenes.subdivide(tris, np.zeros(len(tris), np.uint32), 2)
    dense = tisect.build_dense(torch.as_tensor(tris))
    r = np.random.default_rng(4)
    o = torch.as_tensor(r.uniform(-0.5, 0.5, (3, 300)).astype(np.float32))
    d = torch.as_tensor(r.normal(size=(3, 300)).astype(np.float32))
    phi = tisect.ray_features_t(o, d / d.norm(dim=0))
    tmax = torch.full((300,), 5.0)
    args = (dense.coeffs, phi, tmax, dense.chunk_bounds)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(x) for x in args]
        bt, bi = torch.ops.tracer_tpu_torch.closest_hit(*fake, None, 64)
        hit = torch.ops.tracer_tpu_torch.any_hit(*fake, True, 3)
    assert [(x.shape, x.dtype, x.device.type) for x in (bt, bi, hit)] == [
        ((300,), torch.float32, "cpu"), ((300,), torch.int32, "cpu"),
        ((300,), torch.bool, "cpu")]
    cuda_lib.reset_counts()
    bt, bi = torch.ops.tracer_tpu_torch.closest_hit(*args, None, 64)
    hit = torch.ops.tracer_tpu_torch.any_hit(*args, None, 64)
    rt, ri = ik.closest_hit_ref(*args)
    assert torch.equal(bt, rt) and torch.equal(bi, ri)
    assert torch.equal(hit, ik.any_hit_ref(*args))
    assert 0 < int(torch.isfinite(bt).sum()) < 300
    plain = cuda_lib.plain_calls
    assert plain["closest_hit"] == plain["any_hit"] == 1
    assert sum(cuda_lib.launches.values()) == 0
    # the public wrappers go through the ops
    ik.closest_hit(*args, stream=True)
    assert cuda_lib.plain_calls["closest_hit_streamed"] == 1


def test_accumulate_color_tensor_form_equals_int_form():
    """The eager merge rounds float64 weights (nf - 1) / nf and 1 / nf
    once to f32; the exported step computes them in f32 from a 0-d
    n_frames, as the JAX package does. The two are the same f32 for
    every n_frames < 2^24, and so are the merged images."""
    n = torch.arange(1, 1 << 24, dtype=torch.int64)
    nf32 = n.to(torch.float32)
    nf64 = n.to(torch.float64)
    assert torch.equal((nf32 - 1.0) / nf32, ((nf64 - 1.0) / nf64).float())
    assert torch.equal(1.0 / nf32, (1.0 / nf64).float())
    r = np.random.default_rng(0)
    acc, new = (torch.as_tensor(r.random((4, 5, 3)).astype(np.float32))
                for _ in range(2))
    for nf in (1, 2, 3, 7, 1000, (1 << 24) - 1):
        assert torch.equal(
            tint.accumulate_color(acc, new, nf),
            tint.accumulate_color(acc, new, torch.tensor(nf)))


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_ops_launch_kernels_on_card(cuda_device):
    """On the card the ops' CUDA implementation launches K1-K4 (counted
    in launches, no plain call) and agrees with the plain version."""
    tris, _, _ = testscenes.cornell_like()
    dense = tisect.build_dense(torch.as_tensor(tris, device=cuda_device))
    r = np.random.default_rng(4)
    o = torch.as_tensor(r.uniform(-0.5, 0.5, (3, 4096)).astype(np.float32),
                        device=cuda_device)
    d = torch.as_tensor(r.normal(size=(3, 4096)).astype(np.float32),
                        device=cuda_device)
    phi = tisect.ray_features_t(o, d / d.norm(dim=0))
    tmax = torch.full((4096,), 5.0, device=cuda_device)
    args = (dense.coeffs, phi, tmax, dense.chunk_bounds)
    cuda_lib.reset_counts()
    for stream in (False, True):
        bt, _ = torch.ops.tracer_tpu_torch.closest_hit(*args, stream, 64)
        hit = torch.ops.tracer_tpu_torch.any_hit(*args, stream, 64)
        rt, _ = ik.closest_hit_ref(*(x.cpu() for x in args))
        assert torch.equal(torch.isfinite(bt).cpu(), torch.isfinite(rt))
        assert torch.equal(hit.cpu(), ik.any_hit_ref(*(x.cpu()
                                                         for x in args)))
    torch.cuda.synchronize()
    launches = cuda_lib.launches
    assert all(launches[k] == 1 for k in ik.VARIANTS), launches
    assert all(cuda_lib.plain_calls[k] == 0 for k in ik.VARIANTS)


@pytest.mark.requires_cuda
def test_loaded_step_on_card(cuda_device):
    """An artifact exported on the card steps as api.step does there, bit
    for bit, through K1/K3 with no plain call."""
    s = _accumulating(3, 0, "auto", h=32, w=32, device=cuda_device)
    step = aot.load(aot.export_step(s))
    cuda_lib.reset_counts()
    _steps_equal(step, s)
    torch.cuda.synchronize()
    assert cuda_lib.launches["closest_hit"] > 0
    assert cuda_lib.launches["any_hit"] > 0
    assert sum(cuda_lib.plain_calls.values()) == 0
