"""The shading of one bounce around its shadow query: NEE + MIS and the
BSDF step of engine/integrator._bounce as two hand-written CUDA kernels
(csrc/shade.cu), and their plain PyTorch version.

  prepare(state, alive, inter, d, wavelen, cum_dist, light_table, trans)
      -> Prepared: the light select, the light-area and the MIS BSDF
      samples, both halves' contributions and their packed shadow rays
      (engine/direct.estimate_direct_prepare), then the bounce's own BSDF
      sample, Russian roulette and the next ray
  scene_mod.any_hit(scene, *Prepared.shadow)   K3 or the LBVH walk, as is
  finish(blocked, Prepared, emission, ambient, first) -> radiance (N,)
      occlusion, the light count, the surface's emission on a lane's
      first bounce and the hit / miss / ambient select

The kernels replace no TPU kernel: the JAX package leaves this
arithmetic to XLA, which fuses it; PyTorch runs it eagerly as ~1,750
elementwise ops a bounce, each a pass over the lanes and a launch from
the host. Both kernels are bound by bytes (about 200 B a lane in and
out) and by the lanes' transcendentals; one thread a lane, every
operand read once.

Dispatch: prepare and finish call the torch.library custom ops
tracer_tpu_torch::shade_prepare and tracer_tpu_torch::shade_finish, whose
CPU implementation is the plain version (engine/direct.py's light select
and split MIS estimate, and the BSDF step below: bit for bit what the
bounce gave before the kernels) and whose CUDA implementation
launches the kernel or raises. The fake rules give torch.export the
output shapes, so the exported step (utils/aot.py) holds the two ops.
The kernels keep the plain version's f32 arithmetic: IEEE divide and
square root, each product rounded on its own as PyTorch's elementwise
ops round it, the same CUDA math functions, and the RNG in uint32 over
the pool's int64 words, so a lane's RNG state leaves them as it leaves
the plain version, bit for bit. Each launch of shade_prepare adds its
lanes to the counter shade.lanes (utils/profiling).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_tpu_torch.engine import direct as direct_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import materials, shapes
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.utils import profiling

# Lanes per CUDA block of both kernels (csrc/shade.cu kShadeBlock, checked
# at load).
BLOCK = 128
cuda_lib.expect(shade_block=BLOCK)

# Bits of the per-lane flags shade_prepare hands to shade_finish.
BF_L, BF_B, BOTH, HIT, MISS = 1, 2, 4, 8, 16

# The kernels' names in cuda_lib's counts.
KERNELS = ("shade_prepare", "shade_finish")


class Prepared(NamedTuple):
    """What shade_prepare gives: the bounce's outcome and what
    shade_finish needs beside the shadow query's answer."""
    state: torch.Tensor     # (N,) int64 rng words after the bounce
    hit: torch.Tensor       # (N,) bool: alive and hit a surface
    scatters: torch.Tensor  # (N,) bool: the BSDF sample survived roulette
    o: torch.Tensor         # (3, N) next ray of a scattering lane
    d: torch.Tensor         # (3, N)
    cum_dist: torch.Tensor  # (N,) path distance so far
    rec_dist: torch.Tensor  # (N,) cum_dist on a hit, +inf otherwise
    shadow: direct_mod.ShadowQuery
    terms: torch.Tensor     # (2, N) DirectTerms.light, DirectTerms.bsdf
    flags: torch.Tensor     # (N,) uint8: BF_L, BF_B, BOTH, HIT, MISS
    n_lights: int


# ---------------------------------------------------------------------------
# The plain version

def _bsdf_step(state, wo, inter: scene_mod.Interaction, hit):
    """One BSDF sample with unit-weight Russian roulette
    (tracer_tpu/engine/integrator.py:85-118): (state, scatters, o, d)."""
    state, wi, bsdf, pdf_val, pdf_kind = materials.sample_dir(
        state, wo, inter.normal, inter.mat)
    pdf = torch.where(pdf_kind == materials.PDF_DELTA, 1.0,
                      torch.where(pdf_kind == materials.PDF_NONZERO,
                                  pdf_val, 0.0))
    cos_falloff = torch.abs(la.v3_dot(inter.normal, wi))
    p_terminate = 1.0 - bsdf * cos_falloff / pdf
    state, u = prng.next_unit(state)
    scatters = hit & (pdf != 0) & ~(u < p_terminate)
    o_new, d_new = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi)
    return state, scatters, o_new, d_new


def _prepare_plain(state, alive, ok, t, pos, normal, color, roughness,
                   metalness, ref_ix, opacity, d, wavelen, cum_dist,
                   light_table, sectors, trans_kind, trans_theta,
                   trans_emission):
    inter = scene_mod.Interaction(
        ok=ok, t=t, pos=pos, normal=normal,
        mat=materials.MaterialLanes(color, roughness, metalness, ref_ix,
                                    opacity),
        emission_at_wl=None)
    hit = alive & ok
    miss = alive & ~ok
    wo = -d
    n = wo.shape[-1]
    trans = (None if sectors is None else direct_mod.Transmitter(
        trans_kind, sectors, trans_theta, trans_emission))
    state, light, n_lights = direct_mod.select_lane_light(
        state, light_table, wavelen, trans)
    flags = torch.where(hit, HIT, 0) | torch.where(miss, MISS, 0)
    if light is None:
        zero = torch.zeros((2 * n,), device=wo.device)
        query = direct_mod.ShadowQuery(zero, zero.expand(3, -1),
                                       zero.expand(3, -1))
        terms = torch.zeros((2, n), device=wo.device)
    else:
        state, query, dt = direct_mod.estimate_direct_prepare(
            state, wo, inter, light, mask=hit)
        terms = torch.stack([dt.light, dt.bsdf])
        flags = (flags | torch.where(dt.bf_l, BF_L, 0)
                 | torch.where(dt.bf_b, BF_B, 0)
                 | torch.where(dt.both, BOTH, 0))
    cum_dist = torch.where(hit, cum_dist + t, cum_dist)
    rec_dist = torch.where(hit, cum_dist, float("inf"))
    state, scatters, o_new, d_new = _bsdf_step(state, wo, inter, hit)
    return (state, hit, scatters, o_new, d_new, cum_dist, rec_dist,
            query.tmax, query.origin.contiguous(), query.dir.contiguous(),
            terms, flags.to(torch.uint8))


def _finish_plain(blocked, terms, flags, emission, ambient, first,
                  first_all, n_lights):
    hit = (flags & HIT) != 0
    miss = (flags & MISS) != 0
    if n_lights:
        dt = direct_mod.DirectTerms(terms[0], terms[1], (flags & BF_L) != 0,
                                    (flags & BF_B) != 0, (flags & BOTH) != 0)
        direct = (direct_mod.estimate_direct_finish(dt, blocked)
                  * float(n_lights))
    else:
        direct = torch.zeros(flags.shape, device=terms.device)
    if first is not None:
        lit = direct + torch.where(first, emission, 0.0)
    elif first_all:
        lit = direct + emission
    else:
        lit = direct
    return torch.where(hit, lit, torch.where(miss, ambient, 0.0))


# ---------------------------------------------------------------------------
# The kernels' operands

def _lanes(x, device, shape, dtype=torch.float32):
    """A (n,) or (rows, n) operand whose lane axis may be broadcast (stride
    0) or strided, checked, and its strides."""
    return ([cuda_lib.operand(x, device, dtype, shape, strided=True)],
            list(x.stride()))


def _new(like, *shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# The custom ops. The CPU implementation is the plain version, the CUDA
# one the kernel; no device falls back.

_PREPARE_SCHEMA = (
    "(Tensor state, Tensor alive, Tensor ok, Tensor t, Tensor pos, "
    "Tensor normal, Tensor color, Tensor roughness, Tensor metalness, "
    "Tensor ref_ix, Tensor opacity, Tensor d, Tensor wavelen, "
    "Tensor cum_dist, Tensor light_table, Tensor? sectors, float trans_kind, "
    "Tensor? trans_theta, Tensor? trans_emission) -> (Tensor, Tensor, "
    "Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
    "Tensor)")


@torch.library.custom_op("tracer_tpu_torch::shade_prepare", mutates_args=(),
                         device_types="cpu", schema=_PREPARE_SCHEMA)
def _prepare_op(*args):
    cuda_lib.plain("shade_prepare")
    return _prepare_plain(*args)


@_prepare_op.register_kernel("cuda")
def _prepare_cuda(state, alive, ok, t, pos, normal, color, roughness,
                  metalness, ref_ix, opacity, d, wavelen, cum_dist,
                  light_table, sectors, trans_kind, trans_theta,
                  trans_emission):
    n, dev = state.shape[0], state.device
    outs = _prepare_fake(state, *(None,) * 18)
    ptrs, ints = [], [n]
    f32 = torch.float32
    for x, dtype in ((state, torch.int64), (alive, torch.bool),
                     (ok, torch.bool), (t, f32), (color, f32),
                     (roughness, f32), (metalness, f32), (ref_ix, f32),
                     (opacity, f32), (wavelen, f32), (cum_dist, f32)):
        p, s = _lanes(x, dev, (n,), dtype)
        ptrs += p
        ints += s
    for x in (pos, normal, d):
        p, s = _lanes(x, dev, (3, n))
        ptrs += p
        ints += s
    table = light_table.contiguous()
    ptrs.append(cuda_lib.operand(table, dev, shape=(table.shape[0], 23)))
    ints.append(table.shape[0])
    if sectors is None:
        ptrs += [None, None, None]
        ints += [0, 0, 0, 0, 0]
    else:
        ns = sectors.shape[2]
        if ns not in (1, n):
            raise ValueError(f"sectors of shape {tuple(sectors.shape)}")
        s0, s1, s2 = sectors.stride()
        ptrs += [cuda_lib.operand(sectors, dev,
                                  shape=(sectors.shape[0], 9, ns),
                                  strided=True),
                 cuda_lib.operand(trans_theta, dev, shape=()),
                 cuda_lib.operand(trans_emission.contiguous(), dev,
                                  shape=(6, 2))]
        ints += [sectors.shape[0], s0, s1, s2 if ns > 1 else 0,
                 int(trans_kind)]
    cuda_lib.launch("shade_prepare", dev, ptrs + list(outs), ints)
    profiling.count("shade.lanes", n)
    return outs


@_prepare_op.register_fake
def _prepare_fake(state, *_):
    n = state.shape[0]
    return (_new(state, n, dtype=torch.int64),
            _new(state, n, dtype=torch.bool),
            _new(state, n, dtype=torch.bool), _new(state, 3, n),
            _new(state, 3, n), _new(state, n), _new(state, n),
            _new(state, 2 * n), _new(state, 3, 2 * n), _new(state, 3, 2 * n),
            _new(state, 2, n), _new(state, n, dtype=torch.uint8))


_FINISH_SCHEMA = ("(Tensor blocked, Tensor terms, Tensor flags, "
                  "Tensor emission, Tensor ambient, Tensor? first, "
                  "bool first_all, int n_lights) -> Tensor")


@torch.library.custom_op("tracer_tpu_torch::shade_finish", mutates_args=(),
                         device_types="cpu", schema=_FINISH_SCHEMA)
def _finish_op(*args):
    cuda_lib.plain("shade_finish")
    return _finish_plain(*args)


@_finish_op.register_kernel("cuda")
def _finish_cuda(blocked, terms, flags, emission, ambient, first, first_all,
                 n_lights):
    n, dev = flags.shape[0], flags.device
    out = _finish_fake(blocked, terms, flags)
    ptrs = [cuda_lib.operand(blocked, dev, torch.bool, (2 * n,)),
            cuda_lib.operand(terms, dev, torch.float32, (2, n)),
            cuda_lib.operand(flags, dev, torch.uint8, (n,))]
    ints = [n]
    for x, dtype in ((emission, torch.float32), (ambient, torch.float32),
                     (first, torch.bool)):
        if x is None:
            continue
        p, s = _lanes(x, dev, (n,), dtype)
        ptrs += p
        ints += s
    if first is None:
        ptrs.append(None)
        ints.append(0)
    ints += [-1 if first is not None else int(first_all), n_lights]
    cuda_lib.launch("shade_finish", dev, ptrs + [out], ints)
    return out


@_finish_op.register_fake
def _finish_fake(blocked, terms, flags, *_):
    return _new(terms, flags.shape[0])


# ---------------------------------------------------------------------------
# What the bounce calls

def prepare_args(state, alive, inter: scene_mod.Interaction, d, wavelen,
                 cum_dist, light_table,
                 trans: direct_mod.Transmitter | None) -> tuple:
    """The operands of the op tracer_tpu_torch::shade_prepare, in its
    schema's order, from prepare's arguments."""
    m = inter.mat
    if trans is None:
        tr = (None, 0.0, None, None)
    else:
        tr = (trans.sectors, float(trans.kind), trans.theta, trans.emission)
    return (state, alive, inter.ok, inter.t, inter.pos, inter.normal,
            m.color, m.roughness, m.metalness, m.ref_ix, m.opacity, d,
            wavelen, cum_dist, light_table, *tr)


def prepare(state, alive, inter: scene_mod.Interaction, d, wavelen,
            cum_dist, light_table,
            trans: direct_mod.Transmitter | None) -> Prepared:
    """The op tracer_tpu_torch::shade_prepare on one bounce's lanes: alive
    (N,) bool, inter the closest_interaction of the rays d (3, N), wavelen
    and cum_dist (N,), the scene's light_table (L, 23) and the
    transmitter or None. Every lane draws from state, live or not."""
    out = torch.ops.tracer_tpu_torch.shade_prepare(*prepare_args(
        state, alive, inter, d, wavelen, cum_dist, light_table, trans))
    n_lights = light_table.shape[0] + (0 if trans is None
                                       else trans.sectors.shape[0])
    return Prepared(*out[:7], direct_mod.ShadowQuery(*out[7:10]),
                    out[10], out[11], n_lights)


def finish_args(blocked, prep: Prepared, emission, ambient, first) -> tuple:
    """The operands of the op tracer_tpu_torch::shade_finish, in its
    schema's order, from finish's arguments."""
    lanes = first if isinstance(first, torch.Tensor) else None
    return (blocked, prep.terms, prep.flags, emission, ambient, lanes,
            bool(first) if lanes is None else False, prep.n_lights)


def finish(blocked, prep: Prepared, emission, ambient, first):
    """The op tracer_tpu_torch::shade_finish: blocked (2N,) bool, any_hit
    of prep.shadow; emission and ambient (N,) at the lanes' wavelengths;
    first says where a hit adds the surface's own emission, a python bool
    for all lanes or (N,) bool. Returns the bounce's radiance (N,)."""
    return torch.ops.tracer_tpu_torch.shade_finish(
        *finish_args(blocked, prep, emission, ambient, first))
