"""The pool's refill (engine/refill.py, the op tracer_tpu_torch::refill,
csrc/refill.cu K13).

On the CPU the op is the plain version. It must give what the pool body's
refill gave before the op bit for bit; _before_* below are those
functions as they were, the yardstick. On the card (requires_cuda) the
kernel is held to the plain version run there: every output equal bit
for bit on every lane."""

import math

import pytest
import torch

import tracer_tpu_torch as T
from tracer_tpu_torch.engine import refill
from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.utils import profiling, testscenes

torch.set_num_threads(2)

ORIGIN = (0.0, 0.8, 1.8)


# ---------------------------------------------------------------------------
# The refill as it was before the op

def _before_sample_wavelength(state, conf):
    n_channels = conf.sensor_mu.shape[0]
    b0, b1 = prng.salted_pair(state, cam_mod._SALT_WAVELENGTH)
    state, _ = prng.next_u32(state)
    state, _ = prng.next_u32(state)
    channel = (b0 % n_channels).to(torch.int32)
    p = (b1 >> 8).to(torch.float32) * prng._UNIT_F
    mu = conf.sensor_mu[channel.long()]
    sigma = conf.sensor_sigma[channel.long()]
    wavelen = mu + sigma * torch.special.ndtri(torch.clamp_min(p, 1e-12))
    return state, wavelen, channel


def _before_sample_ray(state, cam, wh, jx, iy):
    conf = cam.conf
    w_f, h_f = float(wh[0]), float(wh[1])
    ratio = w_f / h_f
    state0 = state
    state, (ox, oy) = prng.in_unit_square(state)
    x = (jx + ox * conf.offset_radius) / w_f
    y = (iy + oy * conf.offset_radius) / h_f
    theta = ox * (2.0 * math.pi / prng.UNIT_SCALE)
    lr = torch.sqrt(oy)
    lx, ly = lr * torch.cos(theta), lr * torch.sin(theta)
    lens_radius = conf.aperture / 2.0
    half_height = torch.tan(conf.field_of_view / 2.0)
    half_width = ratio * half_height
    d = cam_mod.cam_dir(cam)[:, None]
    u = cam_mod.cam_right(cam)[:, None]
    v = cam_mod.cam_up(cam)[:, None]
    w_vec = -d
    fd = conf.focal_dist
    origin0 = cam.origin[:, None]
    lower_left = (origin0
                  - (half_width * fd) * u
                  - (half_height * fd) * v
                  - fd * w_vec)
    horizontal = (2.0 * half_width * fd) * u
    vertical = (2.0 * half_height * fd) * v
    lens_offset = (lens_radius * lx) * u + (lens_radius * ly) * v
    origin = origin0 + lens_offset
    target = lower_left + x * horizontal + y * vertical
    return state0, origin, la.v3_normalize(target - origin)


def _before_fresh_samples(seed, nonce, cam, w, full_h, row0, s, pix):
    jx = (pix % w).to(torch.float32)
    iy = float(full_h) - ((pix // w).to(torch.float32) + float(row0)) - 1.0
    state = prng.make_streams_per_lane(seed, prng.as_u32(nonce + s),
                                       pix + row0 * w)
    state, wavelen, channel = _before_sample_wavelength(state, cam.conf)
    state, origin, d = _before_sample_ray(state, cam, (w, full_h), jx, iy)
    return state, wavelen, channel, origin.expand(3, pix.shape[0]), d


def _before_refill(c, seed, nonce, cam, w, full_h, row0, n, total, kind):
    """The pool body's refill (and its scanning fan) before the op, on
    the carry c; returns refill.LANES' tensors and the fan's sectors or
    None."""
    active, item, next_item = c["active"], c["item"], c["next_item"]
    idle = ~active
    rank = torch.cumsum(idle, 0)
    cand = next_item + rank - 1
    start = idle & (cand < total)
    next_item = torch.clamp_max(next_item + rank[-1], total)
    item = torch.where(start, cand, item)
    s_new = torch.div(item, n, rounding_mode="floor")
    fresh = _before_fresh_samples(seed, nonce, cam, w, full_h, row0, s_new,
                                  item - s_new * n)
    state = torch.where(start, fresh[0], c["state"])
    wavelen = torch.where(start, fresh[1], c["wavelen"])
    chan = torch.where(start, fresh[2], c["chan"])
    po = torch.where(start, fresh[3], c["po"])
    pd = torch.where(start, fresh[4], c["pd"])
    o = torch.where(start, po, c["o"])
    d = torch.where(start, pd, c["d"])
    bounce = torch.where(start, 0, c["bounce"])
    cum_dist = torch.where(start, 0.0, c["cum_dist"])
    sample_rad = torch.where(start, 0.0, c["sample_rad"])
    sample_min_d = torch.where(start, float("inf"), c["sample_min_d"])
    active = active | start
    sectors = None
    if kind == cam_mod.TRANSMITTER_SCANNING:
        fan = cam_mod.gen_transmitter_sectors(cam, kind, pd)
        sectors = torch.stack([torch.cat(s) for s in fan])
    return (next_item, active, item, state, bounce, o, d, po, pd, wavelen,
            chan, cum_dist, sample_rad, sample_min_d), sectors


# ---------------------------------------------------------------------------
# Lanes

def _state(conf, w, h, device="cpu"):
    return T.init(7, h, w, conf, *testscenes.cornell_like(),
                  cam_origin=ORIGIN, device=device)


def _carry(p, total, n_channels, phase, device="cpu", seed=3):
    """The refill's lanes of a pool of p lanes over total work items:
    "first" as the pool starts (every lane idle), "middle" (a seeded 40%
    idle, items left for all of them), "last" (fewer items left than idle
    lanes) and "full" (no lane idle); past the first, every lane holds
    seeded values that a passing lane must keep."""
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    if phase == "first":
        c = {"next_item": torch.tensor(0), "active": torch.zeros(
                 p, dtype=torch.bool),
             "item": torch.full((p,), total), "state": torch.zeros(
                 p, dtype=torch.int64),
             "bounce": torch.zeros(p, dtype=torch.int32),
             "wavelen": torch.zeros(p), "chan": torch.zeros(
                 p, dtype=torch.int32),
             "cum_dist": torch.zeros(p), "sample_rad": torch.zeros(p),
             "sample_min_d": torch.full((p,), float("inf"))}
        c.update({k: torch.zeros(3, p) for k in ("o", "d", "po", "pd")})
    else:
        active = (torch.ones(p, dtype=torch.bool) if phase == "full"
                  else torch.rand(p, generator=g) < 0.6)
        idle = int((~active).sum())
        left = idle // 2 if phase == "last" else idle + 5
        c = {"next_item": torch.tensor(max(0, total - left)),
             "active": active,
             "item": torch.randint(0, total, (p,), generator=g),
             "state": torch.randint(0, 1 << 32, (p,), generator=g),
             "bounce": torch.randint(0, 16, (p,), generator=g,
                                     dtype=torch.int32),
             "wavelen": 400 + 300 * torch.rand(p, generator=g),
             "chan": torch.randint(0, n_channels, (p,), generator=g,
                                   dtype=torch.int32),
             "cum_dist": 3 * torch.rand(p, generator=g),
             "sample_rad": torch.rand(p, generator=g),
             "sample_min_d": torch.where(torch.rand(p, generator=g) < 0.5,
                                         float("inf"),
                                         torch.rand(p, generator=g))}
        c.update({k: torch.randn(3, p, generator=g, dtype=f32)
                  for k in ("o", "d", "po", "pd")})
    return {k: v.to(device) for k, v in c.items()}


def _op(s, c, seed, nonce, w, full_h, row0, n, total):
    """The op on the carry c of state s: (refill.LANES' tensors, the
    fan's sectors or None)."""
    dev = c["active"].device
    rank = torch.cumsum(~c["active"], 0)
    lanes, sectors = refill.refill(
        rank, c, refill.camera_operand(s.cam, w, full_h),
        refill.device_scalar(seed, dev), refill.device_scalar(nonce, dev),
        total, n, w, full_h, row0, s.transmitter_kind)
    return tuple(lanes[k] for k in refill.LANES), sectors


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


PHASES = ("first", "middle", "last", "full")


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("conf", [0, 1, 2])
def test_plain_refill_equals_the_refill_before_it(conf, phase):
    """The op (its plain version on the CPU) gives the body's refill as
    it was before the op bit for bit: every lane's work item, stream,
    wavelength, channel, primary ray and reset, the counter, and the
    scanning fan (config 2), as the pool starts, in its middle, at the
    last partial refill and with no lane idle."""
    w, h, spp, p = 12, 10, 3, 97
    s = _state(conf, w, h)
    n = w * h
    total = n * spp
    c = _carry(p, total, s.cam.conf.sensor_mu.shape[0], phase)
    cuda_lib.reset_counts()
    got, sectors = _op(s, c, s.seed, 5, w, h, 0, n, total)
    want, want_sectors = _before_refill(c, s.seed, 5, s.cam, w, h, 0, n,
                                        total, s.transmitter_kind)
    for name, a, b in zip(refill.LANES, got, want):
        assert _same(a, b), (conf, phase, name)
    assert (sectors is None) == (want_sectors is None) == (conf != 2)
    if conf == 2:
        assert sectors.shape == (cam_mod.TRANSMITTER_SECTORS, 9, p)
        assert _same(sectors, want_sectors)
    started = int((got[1] & ~c["active"]).sum())
    expect = {"first": p, "middle": int((~c["active"]).sum()),
              "last": int((~c["active"]).sum()) // 2, "full": 0}[phase]
    assert started == expect
    assert cuda_lib.plain_calls["refill"] == 1
    assert sum(cuda_lib.launches.values()) == 0


@pytest.mark.parametrize("conf", [0, 2])
def test_plain_refill_of_a_band_with_tensor_seed(conf):
    """Rows row0 .. row0 + h of a frame full_h high (parallel/render.py's
    tiles), seed and nonce as 0-d tensors (the exported step's): the op
    gives the refill before it bit for bit, and the same as with python
    ints."""
    w, h, full_h, row0, spp, p = 12, 7, 24, 9, 2, 61
    s = _state(conf, w, h)
    n = w * h
    total = n * spp
    for phase in ("first", "middle"):
        c = _carry(p, total, s.cam.conf.sensor_mu.shape[0], phase, seed=8)
        seed_t, nonce_t = torch.tensor(s.seed), torch.tensor((1 << 32) - 2)
        got, sectors = _op(s, c, seed_t, nonce_t, w, full_h, row0, n, total)
        want, want_sectors = _before_refill(c, seed_t, nonce_t, s.cam, w,
                                            full_h, row0, n, total,
                                            s.transmitter_kind)
        ints, _ = _op(s, c, s.seed, (1 << 32) - 2, w, full_h, row0, n, total)
        for name, a, b, i in zip(refill.LANES, got, want, ints):
            assert _same(a, b) and _same(a, i), (conf, phase, name)
        if conf == 2:
            assert _same(sectors, want_sectors)


@pytest.mark.parametrize("conf", [0, 1, 2])
def test_fake_rule_gives_the_op_shapes(conf):
    """The fake rule gives what the CUDA implementation allocates (it
    allocates through it) and what the plain version returns: shapes,
    dtypes and device of every output; the fan's sectors with the
    scanning transmitter alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    w, h, p = 8, 6, 40
    s = _state(conf, w, h)
    total = w * h * 2
    c = _carry(p, total, s.cam.conf.sensor_mu.shape[0], "middle")
    args = (torch.cumsum(~c["active"], 0), *(c[k] for k in refill.LANES),
            refill.camera_operand(s.cam, w, h), torch.tensor(s.seed),
            torch.tensor(3))
    tail = (total, w * h, w, h, 0, s.transmitter_kind)
    real = torch.ops.tracer_tpu_torch.refill(*args, *tail)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = torch.ops.tracer_tpu_torch.refill(
            *[mode.from_tensor(x) for x in args], *tail)
    key = [(tuple(x.shape), x.dtype, x.device.type) for x in real]
    assert [(tuple(x.shape), x.dtype, x.device.type) for x in fake] == key
    assert key[:5] == [((), torch.int64, "cpu"), ((p,), torch.bool, "cpu"),
                       ((p,), torch.int64, "cpu"), ((p,), torch.int64, "cpu"),
                       ((p,), torch.int32, "cpu")]
    fan = (cam_mod.TRANSMITTER_SECTORS, 9, p) if conf == 2 else (0,)
    assert key[14] == (fan, torch.float32, "cpu")


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _unequal(a, b):
    """Values of a not equal to b's in every bit, and the largest
    relative gap among them (0 if none)."""
    if a.shape != b.shape:
        return -1, float("inf")
    ne = _bits(a) != _bits(b)
    if not ne.any() or not a.is_floating_point():
        return int(ne.sum()), 0.0
    x, y = a[ne].double(), b[ne].double()
    return int(ne.sum()), float(((x - y).abs() / y.abs()).nan_to_num(
        nan=float("inf")).max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("conf,p", [(0, 2_097_152), (0, 300_007),
                                    (2, 2_097_152), (2, 300_007)])
def test_kernel_matches_plain_on_card(conf, p, cuda_device):
    """K13 against the plain version run on the card on the same operands,
    at the pool's start, in its middle and at its last partial refill:
    every output equal bit for bit on every lane, starting or passing
    (the kernel keeps the plain version's f32 operations, their order
    and rounding)."""
    w = h = 512
    s = _state(conf, w, h, device=cuda_device)
    n = w * h
    total = n * 16
    dev = cuda_device
    cam = refill.camera_operand(s.cam, w, h)
    seed, nonce = refill.device_scalar(s.seed, dev), refill.device_scalar(
        17, dev)
    for phase in ("first", "middle", "last"):
        c = _carry(p, total, s.cam.conf.sensor_mu.shape[0], phase, dev)
        args = (torch.cumsum(~c["active"], 0),
                *(c[k] for k in refill.LANES), cam, seed, nonce, total, n,
                w, h, 0, s.transmitter_kind)
        cuda_lib.reset_counts()
        k = torch.ops.tracer_tpu_torch.refill(*args)
        pl = refill._plain(*args)
        torch.cuda.synchronize()
        off = {name: _unequal(a, b) for name, a, b in
               zip(refill.LANES + ("sectors",), k, pl)}
        started = int((pl[1] & ~c["active"]).sum())
        print(f"conf {conf} p {p} {phase}: {started} lanes start; values "
              f"not equal bit for bit (count, largest relative gap): {off}")
        assert started > 0
        assert cuda_lib.launches["refill"] == 1
        assert cuda_lib.plain_calls["refill"] == 0
        for name, (count, _) in off.items():
            assert count == 0, (phase, name, off[name])


@pytest.mark.requires_cuda
def test_api_call_launches_the_kernel_every_iteration(cuda_device):
    """One sample_n_frames call (and a capture, config 2) launches K13
    once a pool iteration (pool.iters), refill.lanes is the pool's
    lane-iterations, and the plain version never runs."""
    for conf, call in ((0, lambda s: T.sample_n_frames(s, 3)),
                       (2, lambda s: T.sample_points_n(s, 2))):
        s = _state(conf, 64, 48, device=cuda_device)
        cuda_lib.reset_counts()
        profiling.reset()
        with profiling.tracing():
            call(s)
            torch.cuda.synchronize()
        c = profiling.counters()
        assert c["pool.iters"] > 0
        assert cuda_lib.launches["refill"] == c["pool.iters"]
        assert c["refill.lanes"] == c["pool.lane_iters"]
        assert cuda_lib.plain_calls["refill"] == 0


@pytest.mark.requires_cuda
def test_kernel_does_not_spill(cuda_device, tmp_path):
    """ptxas -v of csrc/refill.cu with the library's flags: both variants
    of K13 (with and without the fan) at zero spill bytes."""
    import subprocess
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
           str(tmp_path / "refill.so"), str(cuda_lib.CSRC / "refill.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    res = {k: v for k, v in cuda_lib.kernel_resources(
        proc.stdout + proc.stderr).items() if "refill" in k}
    print(res)
    assert len(res) == 2
    for k, v in res.items():
        assert v["spill_stores"] == v["spill_loads"] == 0, (k, v)
