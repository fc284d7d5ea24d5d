"""The shading of a bounce around its shadow query (engine/shade.py, the
ops tracer_tpu_torch::shade_prepare / shade_finish, csrc/shade.cu).

On the CPU the ops are the plain version: engine/direct.py's split of
estimate_direct (prepare -> any_hit -> finish) and the BSDF step. It must
give what direct_radiance and the BSDF step of the bounce gave before the
split bit for bit; _before_* below are those functions as they were, the
yardstick. On the card (requires_cuda) the kernels are held to the plain
version run there: every output equal bit for bit on every lane."""

import dataclasses

import numpy as np
import pytest
import torch

import tracer_tpu_torch as T
from tracer_tpu_torch.engine import direct as direct_mod
from tracer_tpu_torch.engine import integrator as tint
from tracer_tpu_torch.engine import refill
from tracer_tpu_torch.engine import shade
from tracer_tpu_torch.models import lights as lights_mod
from tracer_tpu_torch.models import scene as scene_mod
from tracer_tpu_torch.ops import cuda_lib
from tracer_tpu_torch.ops import linalg as la
from tracer_tpu_torch.ops import materials, shapes
from tracer_tpu_torch.ops import rng as prng
from tracer_tpu_torch.ops import spectrum as spec
from tracer_tpu_torch.utils import profiling, testscenes

torch.set_num_threads(2)

ORIGIN = (0.0, 0.8, 1.8)


# ---------------------------------------------------------------------------
# The bounce's shading as it was before the split

def _before_estimate_direct(state, scene, wo, inter, light, mask=None):
    is_point = light.kind == lights_mod.KIND_POINT
    e1 = light.b - light.a
    e2 = light.c - light.a
    area = la.v3_norm(la.v3_cross(e1, e2)) * 0.5
    inv_area = 1.0 / torch.clamp_min(area, 1e-30)
    state, (u, v) = prng.in_triangle(state)
    p_area = light.a + u * e1 + v * e2
    lightp = torch.where(is_point, light.a, p_area)
    wi_l = la.v3_normalize(lightp - inter.pos, eps=1e-30)
    in_radiance = direct_mod.incident_radiance(light, inter.pos, lightp)
    light_pdf = torch.where(is_point, 1.0, inv_area)
    f_l = (materials.bsdf_f(wo, wi_l, inter.normal, inter.mat)
           * torch.abs(la.v3_dot(wi_l, inter.normal)))
    scattering_pdf = materials.bsdf_pdf(wo, wi_l, inter.normal, inter.mat)
    weight_l = direct_mod.balance(light_pdf, scattering_pdf)
    state, wi_b, bsdf_b, pdf_b, kind_b = materials.sample_dir(
        state, wo, inter.normal, inter.mat)
    o_b, d_b = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi_b)
    hit_ok, _, lh_pos, _ = shapes.hit_triangle_v(
        shapes.F32_HIGHEST, o_b, d_b, light.a, light.b, light.c)
    bf_l, so_l, sd_l, st_l = direct_mod._shadow_ray(inter.pos, inter.normal,
                                                    lightp)
    bf_b, so_b, sd_b, st_b = direct_mod._shadow_ray(inter.pos, inter.normal,
                                                    lh_pos)
    in_rad_b = direct_mod.incident_radiance(light, inter.pos, lh_pos)
    live_l = (~bf_l & (light_pdf != 0) & (in_radiance != 0) & (f_l != 0)
              & (weight_l != 0))
    live_b = (~is_point & hit_ok & ~bf_b & (in_rad_b != 0)
              & (((kind_b == materials.PDF_DELTA)
                  | (kind_b == materials.PDF_NONZERO)) & (bsdf_b != 0)))
    if mask is not None:
        live_l &= mask
        live_b &= mask
    b_only = live_b & ~live_l
    both = live_b & live_l
    n = wi_l.shape[-1]
    blocked = scene_mod.any_hit(
        scene,
        torch.cat([torch.where(live_l | live_b,
                               torch.where(b_only, st_b, st_l), 0.0),
                   torch.where(both, st_b, 0.0)]),
        torch.cat([torch.where(b_only, so_b, so_l), so_b], dim=1),
        torch.cat([torch.where(b_only, sd_b, sd_l), sd_b], dim=1))
    occ = bf_l | blocked[:n]
    occ_b = bf_b | torch.where(both, blocked[n:], blocked[:n])
    in_radiance = torch.where(occ, 0.0, in_radiance)
    light_part = torch.where(
        (light_pdf == 0) | (in_radiance == 0), 0.0,
        f_l * weight_l * in_radiance / light_pdf)
    f_b = bsdf_b * torch.abs(la.v3_dot(wi_b, inter.normal))
    weight_b = direct_mod.balance(pdf_b, inv_area)
    contrib = torch.where(
        kind_b == materials.PDF_DELTA, f_b * in_rad_b,
        torch.where(kind_b == materials.PDF_NONZERO,
                    f_b * in_rad_b * weight_b / torch.clamp_min(pdf_b, 1e-30),
                    0.0))
    bsdf_part = torch.where(is_point | ~hit_ok | occ_b, 0.0, contrib)
    return state, light_part + bsdf_part


def _before_direct_radiance(state, scene, wo, inter, wavelen, trans=None,
                            mask=None):
    state, light, n_lights = direct_mod.select_lane_light(
        state, scene.light_table, wavelen, trans)
    if light is None:
        return state, torch.zeros((wo.shape[-1],), device=wo.device)
    state, radiance = _before_estimate_direct(state, scene, wo, inter, light,
                                              mask=mask)
    return state, radiance * float(n_lights)


def _before_bounce(state, scene, alive, first, o, d, wavelen, ambient,
                   cum_dist, trans):
    far = torch.finfo(torch.float32).max
    inter = scene_mod.closest_interaction(
        scene, torch.where(alive, far, 0.0), o, d, wavelen)
    hit = alive & inter.ok
    miss = alive & ~inter.ok
    wo = -d
    state, direct = _before_direct_radiance(state, scene, wo, inter, wavelen,
                                            trans, mask=hit)
    if first is True:
        lit = direct + inter.emission_at_wl
    elif first is False:
        lit = direct
    else:
        lit = direct + torch.where(first, inter.emission_at_wl, 0.0)
    cum_dist = torch.where(hit, cum_dist + inter.t, cum_dist)
    rec_dist = torch.where(hit, cum_dist, float("inf"))
    radiance = torch.where(hit, lit, torch.where(miss, ambient, 0.0))
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
    return tint.Bounce(state, hit, radiance, cum_dist, rec_dist, scatters,
                       o_new, d_new)


# ---------------------------------------------------------------------------
# Lanes

def _scene_arrays(kind):
    if kind == "prism":
        return testscenes.prism_scene()
    tris, tm, mats = testscenes.cornell_like()
    if kind == "dark":   # the ceiling light's emission killed
        mats = mats.copy()
        mats[4, 16:28] = [-1, 0] * 6
    return tris, tm, mats


def _state(conf, kind, w, h, device="cpu"):
    """A state of sensor config conf over scene kind: cornell, dark (no
    emitter), point (cornell and a point light) or prism."""
    s = T.init(7, h, w, conf, *_scene_arrays(kind), cam_origin=ORIGIN,
               device=device)
    if kind == "point":
        s = dataclasses.replace(s, scene=scene_mod.add_point_light(
            s.scene, (0.1, 1.2, 0.3), spec.uniform_spectrum(2.0)))
    return s


def _lanes(s, n, seed=11):
    """Bounce-0 operands of n work items over s's pixels (item j: sample
    j // pixels of pixel j % pixels), a seeded fifth of them dead, the
    transmitter of s's sensor and a blue sky's ambient."""
    dev = s.img.device
    w, h = s.width, s.height
    item = torch.arange(n, device=dev)
    smp = torch.div(item, w * h, rounding_mode="floor")
    state, wavelen, _, origin, d = refill.fresh_samples(
        s.seed, 3, refill.camera_operand(s.cam, w, h), w, h, 0, smp,
        item - smp * (w * h))
    r = np.random.default_rng(seed)
    alive = torch.as_tensor(r.random(n) > 0.2, device=dev)
    cum = torch.as_tensor(r.uniform(0, 2, n).astype(np.float32), device=dev)
    trans = direct_mod.transmitter(s.cam, s.transmitter_kind, d)
    ambient = spec.lookup_table(
        wavelen, torch.as_tensor(spec.bright_blue_sky(), device=dev))
    return state, alive, origin, d, wavelen, cum, trans, ambient


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


CASES = [(0, "cornell"), (1, "cornell"), (2, "cornell"), (0, "dark"),
         (2, "dark"), (0, "point"), (0, "prism")]


@pytest.mark.parametrize("conf,kind", CASES)
def test_split_bounce_equals_the_bounce_before_it(conf, kind):
    """_bounce through the ops (their plain version on the CPU) gives the
    bounce before the split bit for bit, at bounce 0 and one bounce
    further, with first as a bool and as a tensor."""
    s = _state(conf, kind, 12, 10)
    n = 2 * 12 * 10 + 17
    state, alive, o, d, wavelen, cum, trans, ambient = _lanes(s, n)
    o = o.expand(3, n)
    first_lanes = torch.arange(n) % 3 == 0
    cuda_lib.reset_counts()
    for bounce in range(2):
        firsts = ((True, first_lanes) if bounce == 0
                  else (False, first_lanes))
        for first in firsts:
            args = (s.scene, alive, first, o, d, wavelen, ambient, cum,
                    trans)
            got = tint._bounce(state, *args)
            want = _before_bounce(state, *args)
            for name, a, b in zip(tint.Bounce._fields, got, want):
                assert _same(a, b), (conf, kind, bounce, first, name)
        alive = got.scatters
        o = torch.where(alive, got.o, o)
        d = torch.where(alive, got.d, d)
        state, cum = got.state, got.cum_dist
        assert 0 < int(alive.sum()) < n
    assert {k: cuda_lib.plain_calls[k] for k in shade.KERNELS} == {
        "shade_prepare": 4, "shade_finish": 4}
    assert sum(cuda_lib.launches.values()) == 0


def test_fake_rules_give_the_kernels_shapes():
    """The fake rules give what the CUDA implementation allocates (it
    allocates through them) and what the plain version returns: shapes,
    dtypes and device, for each output of both ops."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    s = _state(2, "cornell", 8, 6)
    n = 48
    state, alive, o, d, wavelen, cum, trans, ambient = _lanes(s, n)
    inter = scene_mod.closest_interaction(
        s.scene, shapes.F32_HIGHEST, o.expand(3, n), d, wavelen)
    m = inter.mat
    args = (state, alive, inter.ok, inter.t, inter.pos, inter.normal,
            m.color, m.roughness, m.metalness, m.ref_ix, m.opacity, d,
            wavelen, cum, s.scene.light_table, trans.sectors)
    tail = (float(trans.kind), trans.theta, trans.emission)
    real = torch.ops.tracer_tpu_torch.shade_prepare(*args, *tail)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = torch.ops.tracer_tpu_torch.shade_prepare(
            *[mode.from_tensor(x) for x in args], tail[0],
            *[mode.from_tensor(x) for x in tail[1:]])
    key = [(tuple(x.shape), x.dtype, x.device.type) for x in real]
    assert [(tuple(x.shape), x.dtype, x.device.type) for x in fake] == key
    assert key[:3] == [((n,), torch.int64, "cpu"), ((n,), torch.bool, "cpu"),
                       ((n,), torch.bool, "cpu")]
    assert key[7:] == [((2 * n,), torch.float32, "cpu"),
                       ((3, 2 * n), torch.float32, "cpu"),
                       ((3, 2 * n), torch.float32, "cpu"),
                       ((2, n), torch.float32, "cpu"),
                       ((n,), torch.uint8, "cpu")]
    blocked = torch.zeros((2 * n,), dtype=torch.bool)
    fin = (blocked, real[10], real[11], inter.emission_at_wl, ambient)
    out = torch.ops.tracer_tpu_torch.shade_finish(*fin, None, True, 8)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fout = torch.ops.tracer_tpu_torch.shade_finish(
            *[mode.from_tensor(x) for x in fin], None, True, 8)
    assert (tuple(fout.shape), fout.dtype) == (tuple(out.shape), out.dtype) \
        == ((n,), torch.float32)


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_and_plain(s, n, bounces=2):
    """Per bounce, the ops' outputs on the card (kernels) and the plain
    version run there on the same operands."""
    state, alive, o, d, wavelen, cum, trans, ambient = _lanes(s, n)
    o = o.expand(3, n).contiguous()
    out = []
    for bounce in range(bounces):
        inter = scene_mod.closest_interaction(
            s.scene, torch.where(alive, torch.finfo(torch.float32).max, 0.0),
            o, d, wavelen)
        args = shade.prepare_args(state, alive, inter, d, wavelen, cum,
                                  s.scene.light_table, trans)
        k = torch.ops.tracer_tpu_torch.shade_prepare(*args)
        p = shade._prepare_plain(*args)
        n_lights = s.scene.light_table.shape[0] + (
            0 if trans is None else trans.sectors.shape[0])
        blocked = (scene_mod.any_hit(s.scene, p[7], p[8], p[9]) if n_lights
                   else torch.zeros_like(p[7], dtype=torch.bool))
        first = torch.full((n,), bounce == 0, device=o.device)
        fin = (blocked, inter.emission_at_wl, ambient, first, False,
               n_lights)
        kf = torch.ops.tracer_tpu_torch.shade_finish(
            fin[0], k[10], k[11], *fin[1:])
        pf = shade._finish_plain(fin[0], p[10], p[11], *fin[1:])
        out.append((k, p, kf, pf, alive))
        alive = p[2]
        o = torch.where(alive, p[3], o)
        d = torch.where(alive, p[4], d)
        state, cum = p[0], p[5]
    return out


# The pool's lanes (P = 2,097,152) and a ragged count, on the scenes and
# sensors whose branches the kernels take: scene lights with no
# transmitter (config 0), the per-lane scanning fan (config 2), the
# flash's fan broadcast over the lanes (config 1, sector stride 0), a
# point light, the prism's dielectric lobe, and no light at all (the dark
# box, config 0) or the fan alone (the dark box, config 2).
CARD_CASES = [(0, "cornell", 2_097_152), (0, "cornell", 300_007),
              (2, "cornell", 2_097_152), (2, "cornell", 300_007),
              (1, "cornell", 300_007), (0, "point", 300_007),
              (0, "prism", 300_007), (0, "dark", 300_007),
              (2, "dark", 300_007)]
PREPARED = ("state", "hit", "scatters", "o", "d", "cum_dist", "rec_dist",
            "shadow_tmax", "shadow_o", "shadow_d", "terms", "flags")


def _unequal(a, b):
    """Values of a not equal to b's in every bit, and the largest
    relative gap among them (0 if none)."""
    ne = _bits(a) != _bits(b)
    if not ne.any() or not a.is_floating_point():
        return int(ne.sum()), 0.0
    x, y = a[ne].double(), b[ne].double()
    return int(ne.sum()), float(((x - y).abs() / y.abs()).nan_to_num(
        nan=float("inf")).max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("conf,kind,n", CARD_CASES)
def test_kernels_match_plain_on_card(conf, kind, n, cuda_device):
    """shade_prepare and shade_finish against their plain version run on
    the card on the same operands, at bounce 0 and 1: every output equal
    bit for bit on every lane, live or dead (the kernels keep the plain
    version's f32 operations, their order and rounding)."""
    s = _state(conf, kind, 512, 512, device=cuda_device)
    torch.cuda.synchronize()
    for bounce, (k, p, kf, pf, alive) in enumerate(
            _kernel_and_plain(s, n)):
        torch.cuda.synchronize()
        off = {name: _unequal(a, b) for name, a, b in zip(PREPARED, k, p)}
        off["radiance"] = _unequal(kf, pf)
        print(f"conf {conf} {kind} n {n} bounce {bounce}: "
              f"{int(p[1].sum())} hits, {int((p[7] > 0).sum())} live "
              f"shadow lanes; values not equal bit for bit (count, largest "
              f"relative gap): {off}")
        assert int(p[1].sum()) > 0
        for name, (count, _) in off.items():
            assert count == 0, (bounce, name, off[name])


@pytest.mark.requires_cuda
def test_api_calls_launch_the_kernels_every_bounce(cuda_device):
    """sample_n_frames, sample_points_n and step launch shade_prepare and
    shade_finish once a bounce (pool.iters) with shade.lanes the pool's
    lanes over those bounces, and never the plain version."""
    for conf, call in ((0, lambda s: T.sample_n_frames(s, 3)),
                       (2, lambda s: T.sample_points_n(s, 2)),
                       (0, lambda s: T.step(s))):
        s = _state(conf, "cornell", 64, 48, device=cuda_device)
        cuda_lib.reset_counts()
        profiling.reset()
        with profiling.tracing():
            call(s)
            torch.cuda.synchronize()
        c = profiling.counters()
        assert c["pool.iters"] > 0
        assert {k: cuda_lib.launches[k] for k in shade.KERNELS} == {
            "shade_prepare": c["pool.iters"],
            "shade_finish": c["pool.iters"]}
        assert c["shade.lanes"] == c["pool.lane_iters"]
        assert sum(cuda_lib.plain_calls.values()) == 0


@pytest.mark.requires_cuda
def test_kernels_do_not_spill(cuda_device, tmp_path):
    """ptxas -v of csrc/shade.cu with the library's flags: every shade
    kernel at zero spill bytes."""
    import subprocess
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
           str(tmp_path / "shade.so"), str(cuda_lib.CSRC / "shade.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    res = {k: v for k, v in cuda_lib.kernel_resources(
        proc.stdout + proc.stderr).items() if "shade" in k}
    print(res)
    assert len(res) == 4   # three prepare variants and finish
    for k, v in res.items():
        assert v["spill_stores"] == v["spill_loads"] == 0, (k, v)
