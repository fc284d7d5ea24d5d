"""The closest hit's surface interaction (engine/interaction.py, the op
tracer_tpu_torch::interaction, csrc/interaction.cu K16).

On the CPU the op is the plain version. models/scene.closest_interaction,
the query and then the op, must give what it gave before the op bit for
bit; _before_closest_interaction below is that function as it was, the
yardstick, on the dense accel (one resident chunk), the dense accel's
sorted and streamed query (a subdivided box past STREAM_MIN_T_PAD, every
query sorted) and the LBVH. On the card (requires_cuda) the kernel is
held to the plain version run there: every output equal bit for bit on
every lane."""

import pytest
import torch

import tracer_tpu_torch as T
from tracer_tpu_torch.engine import interaction
from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import bvh as bvh_mod
from tracer_tpu_torch.ops import cuda_lib, intersect, materials, shapes
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.utils import kernel_cases, profiling, testscenes

torch.set_num_threads(2)

ORIGIN = (0.0, 0.8, 1.8)
FAR = shapes.F32_HIGHEST
FAR_LANE = torch.finfo(torch.float32).max   # a live lane's tmax in the pool
# subdivide(cornell_like, 5): 22,528 triangles in 88 chunks of 256, past
# ik.STREAM_MIN_T_PAD, so the closest query walks K2's streamed path
SORTED_LEVELS = 5


# ---------------------------------------------------------------------------
# closest_interaction as it was before the op

def _before_closest_interaction(scene, tmax, origin, d, wavelen):
    if isinstance(scene.accel, intersect.DenseTris):
        ok, t, _, pos, normal, aux = intersect.closest_hit(
            scene.accel, tmax, origin, d)
        lane_mat = aux.long()
    else:
        ok, t, tri_idx, pos, normal = scene_mod.closest_hit(scene, tmax,
                                                            origin, d)
        lane_mat = scene.tri_mat[torch.where(ok, tri_idx, 0).long()].long()
    rows_t = scene.mat_rows[lane_mat].T   # (28, N)
    mat, emission = materials.at_wavelength_rows(rows_t, wavelen)
    return scene_mod.Interaction(ok=ok, t=t, pos=pos, normal=normal, mat=mat,
                                 emission_at_wl=emission)


# ---------------------------------------------------------------------------
# Scenes and lanes

def _state(accel, conf, w=24, h=16, device="cpu"):
    tris, tm, mats = testscenes.cornell_like()
    if accel == "sorted":
        tris, tm = testscenes.subdivide(tris, tm, levels=SORTED_LEVELS)
    return T.init(7, h, w, conf, tris, tm, mats, cam_origin=ORIGIN,
                  accel="lbvh" if accel == "lbvh" else "dense",
                  device=device)


def _wavelengths(s, n, seed=5):
    st = prng.make_streams(s.seed, seed, torch.arange(n, device=s.device))
    return cam_mod.sample_wavelength(st, s.cam.conf)[1]


# Lanes of a query: camera rays; their first bounces; bounces with every
# third lane dead (tmax 0, as the pool hands its idle lanes); camera rays
# with every other lane turned out of the box (a miss); one origin for
# every lane (a (3, 1) origin broadcast over the lanes); rays from the
# first bounce's surface points aimed at the light (the emitting
# material).
LANES = ("camera", "bounce", "dead", "miss", "broadcast", "light")


def _lanes(s, kind):
    """(tmax, origin, d, wavelen) of the lanes `kind` on state s."""
    (o, d), (bo, bd), _ = kernel_cases.render_rays(s)
    n = d.shape[1]
    lane = torch.arange(n, device=d.device)
    wl = _wavelengths(s, n)
    if kind == "camera":
        return FAR, o, d, wl
    if kind == "bounce":
        return torch.full((n,), FAR_LANE, device=d.device), bo, bd, wl
    if kind == "dead":
        return torch.where(lane % 3 == 0, 0.0, FAR_LANE), bo, bd, wl
    if kind == "miss":
        out = torch.cat([d[:2], d[2:].abs()])   # +z: out of the open box
        return FAR, o, torch.where(lane % 2 == 1, out, d), wl
    if kind == "broadcast":
        return FAR, s.cam.origin[:, None], d, wl
    light = s.scene.light_table[0]
    target = (light[0:3] + light[3:6] + light[6:9])[:, None] / 3.0
    return FAR, bo, la.v3_normalize(target - bo), wl


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _fields(inter):
    return {"ok": inter.ok, "t": inter.t, "pos": inter.pos,
            "normal": inter.normal, **inter.mat._asdict(),
            "emission_at_wl": inter.emission_at_wl}


@pytest.fixture(scope="module")
def states():
    return {}


def _cached(states, accel, conf):
    if (accel, conf) not in states:
        states[(accel, conf)] = _state(accel, conf)
    return states[(accel, conf)]


@pytest.mark.parametrize("kind", LANES)
@pytest.mark.parametrize("conf", [0, 2])
@pytest.mark.parametrize("accel", ["dense", "sorted", "lbvh"])
def test_plain_interaction_equals_closest_interaction_before_it(
        accel, conf, kind, states, monkeypatch):
    """closest_interaction (the query, then the op: its plain version on
    the CPU) gives what it gave before the op bit for bit, every field on
    every lane: on the resident dense accel, on the dense accel's sorted
    streamed query and on the LBVH, at sensor configs 0 and 2 (their
    wavelengths), for every kind of lane in LANES."""
    if accel == "sorted":
        monkeypatch.setattr(intersect, "resolve_perm",
                            lambda *a, **k: "odmorton")
    s = _cached(states, accel, conf)
    if accel == "sorted":
        assert s.scene.accel.coeffs.shape[1] >= ik.STREAM_MIN_T_PAD
    if accel == "lbvh":
        assert isinstance(s.scene.accel, bvh_mod.LBVH)
    tmax, o, d, wl = _lanes(s, kind)
    cuda_lib.reset_counts()
    got = scene_mod.closest_interaction(s.scene, tmax, o, d, wl)
    assert cuda_lib.plain_calls["interaction"] == 1
    assert sum(cuda_lib.launches.values()) == 0
    want = _before_closest_interaction(s.scene, tmax, o, d, wl)
    for (name, a), b in zip(_fields(got).items(), _fields(want).values()):
        assert _same(a, b), (accel, conf, kind, name)
    for name, x in _fields(got).items():
        assert x.is_contiguous(), name
    ok = got.ok
    assert bool(ok.any())
    if kind == "dead":
        assert not bool(ok[::3].any()) and bool(ok.any())
    if kind == "miss":
        assert not bool(ok[1::2].any()) and bool(ok[0::2].any())
    if kind == "light":
        assert bool((got.emission_at_wl > 0).any())


@pytest.mark.parametrize("accel", ["dense", "lbvh"])
def test_the_query_passes_through_closest_hit(accel, states, monkeypatch):
    """closest_interaction queries through ops/intersect.closest_hit (the
    dense accel) or ops/bvh.closest_hit (the LBVH), by the module's
    attribute, with the rays and tmax it was given: what a wrapper of
    that function sees (portbench's traced call reads the rays and
    result [1]), result [1] being the interaction's t."""
    s = _cached(states, accel, 0)
    tmax, o, d, wl = _lanes(s, "dead")
    mod = intersect if accel == "dense" else bvh_mod
    seen, orig = [], mod.closest_hit

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append((args, out))
        return out

    monkeypatch.setattr(mod, "closest_hit", wrapped)
    got = scene_mod.closest_interaction(s.scene, tmax, o, d, wl)
    (args, out), = seen
    assert args[0] is s.scene.accel and args[1] is tmax
    assert args[2] is o and args[3] is d
    assert out[1] is got.t


@pytest.mark.parametrize("accel", ["dense", "lbvh"])
def test_fake_rule_gives_the_op_shapes(accel, states):
    """The fake rule gives what the CUDA implementation allocates (it
    allocates through it) and what the plain version returns: shapes,
    dtypes and device of every output."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    s = _cached(states, accel, 0)
    tmax, o, d, wl = _lanes(s, "bounce")
    acc = s.scene.accel
    if accel == "dense":
        phi = intersect.ray_features_t(o, d)
        best_t, best_i = intersect.closest_hit_phi(acc, tmax, phi)
        args = interaction.dense_args(acc, s.scene.mat_rows, tmax, o, d, wl,
                                      best_t, best_i)
    else:
        leaf, _ = torch.ops.tracer_tpu_torch.lbvh_closest_hit(
            *bvh_mod.op_args(acc, tmax, o, d))
        args = interaction.lbvh_args(acc, s.scene.tri_mat, s.scene.mat_rows,
                                     tmax, o, d, wl, leaf)
    real = torch.ops.tracer_tpu_torch.interaction(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = torch.ops.tracer_tpu_torch.interaction(
            *[mode.from_tensor(x) if isinstance(x, torch.Tensor) else x
              for x in args])
    key = [(tuple(x.shape), x.dtype, x.device.type) for x in real]
    assert [(tuple(x.shape), x.dtype, x.device.type) for x in fake] == key
    n = d.shape[1]
    assert key == [((n,), torch.bool, "cpu"), ((n,), torch.float32, "cpu"),
                   ((3, n), torch.float32, "cpu"),
                   ((3, n), torch.float32, "cpu"),
                   ((6, n), torch.float32, "cpu")]


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _unequal(a, b):
    """Values of a not equal to b's in every bit (-1: other shapes)."""
    if a.shape != b.shape:
        return -1
    return int((_bits(a) != _bits(b)).sum())


def _card_lanes(s, p, seed):
    """p lanes drawn from the state's camera, first-bounce and miss rays,
    every fifth dead (tmax 0), wavelengths over 380-950 nm (past every
    colour knot and the LiDAR's), the rays contiguous."""
    (o, d), (bo, bd), _ = kernel_cases.render_rays(s)
    out = torch.cat([d[:2], d[2:].abs()])
    oo = torch.cat([o, bo, o], dim=1)
    dd = torch.cat([d, bd, out], dim=1)
    g = torch.Generator(device=d.device).manual_seed(seed)
    pick = torch.randint(0, dd.shape[1], (p,), generator=g, device=d.device)
    lane = torch.arange(p, device=d.device)
    tmax = torch.where(lane % 5 == 0, 0.0, FAR_LANE)
    wl = 380.0 + 570.0 * torch.rand(p, generator=g, device=d.device)
    return tmax, oo[:, pick].contiguous(), dd[:, pick].contiguous(), wl


def _sf10_state(device):
    """SPD tetra at size factor 10 (portbench/scenes/spd_tetra_sf10.py,
    4,194,306 triangles): "auto" builds the LBVH."""
    from portbench.scenes import spd_tetra_sf10
    s = T.init(0, 256, 256, 0, *spd_tetra_sf10.build(),
               cam_origin=spd_tetra_sf10.CAMERA_ORIGIN, device=device)
    assert isinstance(s.scene.accel, bvh_mod.LBVH)
    return s


@pytest.mark.requires_cuda
@pytest.mark.parametrize("p", [2_097_152, 300_007])
@pytest.mark.parametrize("scene", ["box", "box-sub5-sorted", "box-lbvh",
                                   "spd-tetra-sf10"])
def test_kernel_matches_plain_on_card(scene, p, cuda_device):
    """K16 against the plain version run on the card on the same
    operands: every output equal bit for bit on every lane, hit, missed
    or dead, on the box's dense accel (its query resident), on
    subdivide(cornell_like, 5)'s (sorted and streamed: K2), on the box's
    LBVH and on SPD tetra's LBVH past the dense cap; then with a
    broadcast origin."""
    dev = cuda_device
    if scene == "spd-tetra-sf10":
        s = _sf10_state(dev)
    else:
        s = _state({"box": "dense", "box-sub5-sorted": "sorted",
                    "box-lbvh": "lbvh"}[scene], 0, 512, 512, device=dev)
    acc = s.scene.accel
    tmax, o, d, wl = _card_lanes(s, p, seed=p)
    origin_b = o[:, :1]
    for label, origin in (("rays", o), ("broadcast origin", origin_b)):
        if isinstance(acc, intersect.DenseTris):
            perm = "odmorton" if scene == "box-sub5-sorted" else "off"
            phi = intersect.ray_features_t(origin, d)
            best_t, best_i = intersect.closest_hit_phi(acc, tmax, phi,
                                                       perm=perm)
            args = interaction.dense_args(acc, s.scene.mat_rows, tmax,
                                          origin, d, wl, best_t, best_i)
        else:
            leaf, _ = torch.ops.tracer_tpu_torch.lbvh_closest_hit(
                *bvh_mod.op_args(acc, tmax, origin, d))
            args = interaction.lbvh_args(acc, s.scene.tri_mat,
                                         s.scene.mat_rows, tmax, origin, d,
                                         wl, leaf)
        cuda_lib.reset_counts()
        k = torch.ops.tracer_tpu_torch.interaction(*args)
        pl = interaction._plain(*args)
        torch.cuda.synchronize()
        names = ("ok", "t", "pos", "normal", "mat")
        off = {name: _unequal(a, b) for name, a, b in zip(names, k, pl)}
        hits = int(pl[0].sum())
        print(f"{scene} p {p} {label}: {hits} lanes hit; values not equal "
              f"bit for bit: {off}")
        assert 0 < hits < p
        assert cuda_lib.launches["interaction"] == 1
        assert cuda_lib.plain_calls["interaction"] == 0
        assert all(v == 0 for v in off.values()), off


@pytest.mark.requires_cuda
@pytest.mark.parametrize("accel", ["dense", "lbvh"])
def test_api_call_launches_the_kernel_every_iteration(accel, cuda_device):
    """One sample_n_frames call (and a capture, config 2) launches K16
    once a pool iteration (pool.iters), interaction.lanes is the pool's
    lane-iterations, and the plain version never runs."""
    for conf, call in ((0, lambda s: T.sample_n_frames(s, 3)),
                       (2, lambda s: T.sample_points_n(s, 2))):
        s = _state(accel, conf, 64, 48, device=cuda_device)
        cuda_lib.reset_counts()
        profiling.reset()
        with profiling.tracing():
            call(s)
            torch.cuda.synchronize()
        c = profiling.counters()
        assert c["pool.iters"] > 0
        assert cuda_lib.launches["interaction"] == c["pool.iters"]
        assert c["interaction.lanes"] == c["pool.lane_iters"]
        assert cuda_lib.plain_calls["interaction"] == 0


@pytest.mark.requires_cuda
def test_kernel_does_not_spill(cuda_device, tmp_path):
    """ptxas -v of csrc/interaction.cu with the library's flags: both
    variants of K16 (dense and LBVH) at zero spill bytes."""
    import subprocess
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
           str(tmp_path / "interaction.so"),
           str(cuda_lib.CSRC / "interaction.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    res = {k: v for k, v in cuda_lib.kernel_resources(
        proc.stdout + proc.stderr).items() if "interaction" in k}
    print(res)
    assert len(res) == 2
    for k, v in res.items():
        assert v["spill_stores"] == v["spill_loads"] == 0, (k, v)
