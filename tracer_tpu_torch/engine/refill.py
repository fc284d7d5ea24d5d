"""The pool's refill (engine/integrator._pool_round's body) as one
hand-written CUDA kernel, K13 (csrc/refill.cu), and its plain version.

Each iteration the r-th idle lane takes work item next_item + r while
items are left; rank, the prefix sum over the idle lanes, stays one torch
scan before the op. A starting lane draws the camera sample of its item
(sample s of pixel p, stream make_streams(seed, nonce + s, p)): the
wavelength and channel, then the jittered thin-lens primary ray, and its
path starts afresh; every other lane passes through. With the scanning
transmitter (sensor config 2) the fan hangs off each lane's primary ray:
the (TRANSMITTER_SECTORS, 9, P) sectors of every lane, stacked as
direct.transmitter stacks them.

The kernel replaces no TPU kernel: the JAX package leaves the refill to
XLA, which fuses it (tracer_tpu/engine/integrator.py:581). Eager PyTorch
ran it as ~440 passes over the P lanes an iteration (~600 with the fan),
each a launch from the host, the camera sample drawn for every lane and
selected; the kernel draws it on the starting lanes alone.

Dispatch: refill() calls the torch.library custom op
tracer_tpu_torch::refill, whose CPU implementation is the plain version
(_plain: the pool body's refill as it was, over camera_operand) and
whose CUDA implementation launches K13 or raises. The camera's part that
no lane changes, the ray basis, the radii and the channels' rows, is one
small f32 operand (camera_operand), computed once a round. The fake rule
gives torch.export the output shapes, so the exported step
(utils/aot.py) holds the op. The kernel keeps the plain version's f32
operations, their order and rounding (csrc/torch_f32.cuh), so every
output equals the plain version's bit for bit. Each launch adds its
lanes to the counter refill.lanes (utils/profiling).
"""

from __future__ import annotations

import math
import struct

import torch

from tracer_tpu_torch.engine import direct as direct_mod
from tracer_tpu_torch.models import camera as cam_mod
from tracer_tpu_torch.ops import cuda_lib, shapes
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.utils import profiling

# The kernel's name in cuda_lib's counts.
KERNELS = ("refill",)

SECTORS = cam_mod.TRANSMITTER_SECTORS

# The lanes of the pool's carry the op reads and writes, in its order
# (integrator._LANES names).
LANES = ("next_item", "active", "item", "state", "bounce", "o", "d", "po",
         "pd", "wavelen", "chan", "cum_dist", "sample_rad", "sample_min_d")

# camera_operand's layout (csrc/refill.cu reads the same offsets): the
# ray basis (its columns, lens radius, origin, offset radius), the fan's
# radius, then the channels' mu and sigma rows.
_LENS_RADIUS, _ORIGIN, _OFFSET_RADIUS, _TRANS_RADIUS, _MU = 15, 16, 19, 20, 21

# The fan's rim directions: cos and sin of its TRANSMITTER_SECTORS + 1
# angles as disk_sectors_v computes them, as the f32 bits PyTorch rounds
# a python float to.
_ARC = 2.0 * math.pi / SECTORS
_FAN_BITS = tuple(struct.unpack("<i", struct.pack("<f", f(_ARC * k)))[0]
                  for k in range(SECTORS + 1) for f in (math.cos, math.sin))


def camera_operand(cam: cam_mod.Camera, w: int, full_h: int):
    """(21 + 2C,) f32: camera.ray_basis for a w x full_h frame, its
    fields in order, the fan's radius, then the C channels' mu and
    sigma."""
    conf = cam.conf
    return torch.cat([x.reshape(-1) for x in cam_mod.ray_basis(
        cam, (w, full_h))] + [conf.trans_radius.reshape(1), conf.sensor_mu,
                              conf.sensor_sigma])


def device_scalar(x, device):
    """A python int or a 0-d integer tensor (seed, nonce) as a 0-d int64
    tensor on device: a fill, never a copy from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=device)


def _channels(cam) -> int:
    return (cam.shape[0] - _MU) // 2


# ---------------------------------------------------------------------------
# The plain version

def fresh_samples(seed, nonce, cam, w: int, full_h: int, row0: int, s, pix):
    """The camera sample of work item (s, pix) on every lane: stream
    make_streams(seed, nonce + s, pixel id in the full frame), then the
    wavelength, the channel and the primary ray as sample_pixels draws
    them, over camera_operand cam. seed and nonce are python ints or 0-d
    tensors. Returns (state, wavelen, channel, origin (3, P), dir (3,
    P))."""
    c = _channels(cam)
    jx = (pix % w).to(torch.float32)
    iy = float(full_h) - ((pix // w).to(torch.float32) + float(row0)) - 1.0
    state = prng.make_streams_per_lane(seed, prng.as_u32(nonce + s),
                                       pix + row0 * w)
    state, wavelen, channel = cam_mod.draw_wavelength(
        state, cam[_MU:_MU + c], cam[_MU + c:])
    basis = cam_mod.RayBasis(
        *(cam[k:k + 3, None] for k in range(0, _LENS_RADIUS, 3)),
        cam[_LENS_RADIUS], cam[_ORIGIN:_ORIGIN + 3, None],
        cam[_OFFSET_RADIUS])
    state, origin, d = cam_mod.primary_ray(state, basis, (w, full_h), jx,
                                           iy)
    return state, wavelen, channel, origin.expand(3, pix.shape[0]), d


def _fan(cam, pd):
    """The scanning fan off the primary directions pd (3, P), as
    camera.gen_transmitter_sectors and direct.stack_sectors give it."""
    origin = cam[_ORIGIN:_ORIGIN + 3, None].expand(pd.shape)
    return direct_mod.stack_sectors(shapes.disk_sectors_v(
        origin, pd, cam[_TRANS_RADIUS], SECTORS))


def _plain(rank, next_item, active, item, state, bounce, o, d, po, pd,
           wavelen, chan, cum_dist, sample_rad, sample_min_d, cam, seed,
           nonce, total, n, w, full_h, row0, kind):
    # the r-th idle lane takes item next_item + r; the counter stays on
    # the device. The camera sample is drawn for every lane and selected
    idle = ~active
    cand = next_item + rank - 1
    start = idle & (cand < total)
    next_item = torch.clamp_max(next_item + rank[-1], total)
    item = torch.where(start, cand, item)
    s_new = torch.div(item, n, rounding_mode="floor")
    fresh = fresh_samples(seed, nonce, cam, w, full_h, row0, s_new,
                          item - s_new * n)
    state = torch.where(start, fresh[0], state)
    wavelen = torch.where(start, fresh[1], wavelen)
    chan = torch.where(start, fresh[2], chan)
    po = torch.where(start, fresh[3], po)
    pd = torch.where(start, fresh[4], pd)
    o = torch.where(start, po, o)
    d = torch.where(start, pd, d)
    bounce = torch.where(start, 0, bounce)
    cum_dist = torch.where(start, 0.0, cum_dist)
    sample_rad = torch.where(start, 0.0, sample_rad)
    sample_min_d = torch.where(start, float("inf"), sample_min_d)
    active = active | start
    # the transmitter fan hangs off the PRIMARY ray
    sectors = (_fan(cam, pd) if kind == cam_mod.TRANSMITTER_SCANNING
               else pd.new_empty((0,)))
    return (next_item, active, item, state, bounce, o, d, po, pd, wavelen,
            chan, cum_dist, sample_rad, sample_min_d, sectors)


# ---------------------------------------------------------------------------
# The custom op. The CPU implementation is the plain version, the CUDA one
# the kernel; no device falls back.

_SCHEMA = (
    "(Tensor rank, Tensor next_item, Tensor active, Tensor item, "
    "Tensor state, Tensor bounce, Tensor o, Tensor d, Tensor po, Tensor pd, "
    "Tensor wavelen, Tensor chan, Tensor cum_dist, Tensor sample_rad, "
    "Tensor sample_min_d, Tensor cam, Tensor seed, Tensor nonce, int total, "
    "int n, int w, int full_h, int row0, str kind) -> (Tensor, Tensor, "
    "Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
    "Tensor, Tensor, Tensor, Tensor)")


@torch.library.custom_op("tracer_tpu_torch::refill", mutates_args=(),
                         device_types="cpu", schema=_SCHEMA)
def _refill_op(*args):
    cuda_lib.plain("refill")
    return _plain(*args)


@_refill_op.register_fake
def _refill_fake(rank, next_item, active, *args):
    kind = args[-1]
    p, dev = active.shape[0], active.device
    i64, i32, f32 = torch.int64, torch.int32, torch.float32

    def new(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    fan = (SECTORS, 9, p) if kind == cam_mod.TRANSMITTER_SCANNING else (0,)
    return (new(dtype=i64), new(p, dtype=torch.bool), new(p, dtype=i64),
            new(p, dtype=i64), new(p, dtype=i32), new(3, p), new(3, p),
            new(3, p), new(3, p), new(p), new(p, dtype=i32), new(p), new(p),
            new(p), new(*fan))


@_refill_op.register_kernel("cuda")
def _refill_cuda(rank, next_item, active, item, state, bounce, o, d, po, pd,
                 wavelen, chan, cum_dist, sample_rad, sample_min_d, cam,
                 seed, nonce, total, n, w, full_h, row0, kind):
    if kind not in cam_mod.TRANSMITTER_KINDS:
        raise ValueError(f"transmitter kind {kind!r}")
    p, dev = active.shape[0], active.device
    outs = _refill_fake(rank, next_item, active, kind)
    i64, i32, f32 = torch.int64, torch.int32, torch.float32
    lane, v3 = (p,), (3, p)
    ptrs = [cuda_lib.operand(x.contiguous(), dev, dtype, shape)
            for x, dtype, shape in (
                (rank, i64, lane), (next_item, i64, ()),
                (active, torch.bool, lane), (item, i64, lane),
                (state, i64, lane), (bounce, i32, lane), (o, f32, v3),
                (d, f32, v3), (po, f32, v3), (pd, f32, v3),
                (wavelen, f32, lane), (chan, i32, lane),
                (cum_dist, f32, lane), (sample_rad, f32, lane),
                (sample_min_d, f32, lane), (cam, f32, None),
                (seed, i64, ()), (nonce, i64, ()))]
    fan = kind == cam_mod.TRANSMITTER_SCANNING
    cuda_lib.launch("refill", dev,
                    ptrs + list(outs[:14]) + [outs[14] if fan else None],
                    [p, total, n, w, full_h, row0, _channels(cam),
                     *_FAN_BITS])
    profiling.count("refill.lanes", p)
    return outs


# ---------------------------------------------------------------------------
# What the pool calls

def op_args(rank, lanes: dict, cam, seed, nonce, total: int, n: int,
            w: int, full_h: int, row0: int, kind: str) -> tuple:
    """The operands of the op tracer_tpu_torch::refill, in its schema's
    order, from refill's arguments."""
    return (rank, *(lanes[k] for k in LANES), cam, seed, nonce, total, n,
            w, full_h, row0, kind)


def refill(rank, lanes: dict, cam, seed, nonce, total: int, n: int, w: int,
           full_h: int, row0: int, kind: str):
    """The op tracer_tpu_torch::refill on the pool's carry: rank (P,)
    int64, the running count of idle lanes (torch.cumsum(~active)); lanes
    the carry's tensors by the names of LANES; cam the round's
    camera_operand; seed and nonce 0-d int64 (device_scalar); total work
    items of n pixels of a w-wide frame full_h high whose rows row0 ..
    are rendered; kind the transmitter's. Returns (LANES' tensors after
    the refill as a dict, the scanning fan's sectors (TRANSMITTER_SECTORS,
    9, P) or None)."""
    out = torch.ops.tracer_tpu_torch.refill(*op_args(
        rank, lanes, cam, seed, nonce, total, n, w, full_h, row0, kind))
    return (dict(zip(LANES, out)),
            out[-1] if kind == cam_mod.TRANSMITTER_SCANNING else None)
