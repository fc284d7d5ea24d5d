#!/usr/bin/env python3
"""Smoke test of tracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout. Phases, each printed on its own line;
any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc-builds csrc/intersect.cu from the checkout
  3. kernels  both hand kernels against their plain PyTorch versions on
              the card: Cornell camera and first-bounce rays at 512x512,
              a 1,100-triangle 5-chunk random scene with on-plane
              axis-parallel rays and per-lane tmax, and the brute-force
              oracle; then each kernel's median time beside its plain
              version's at the Cornell shapes (CUDA events)
  4. main     the port's main path: init a 512x512 Cornell box, render
              16 spp (sample_n_frames(s, 17)), 3 x step_render; checks
              the image and that every kernel launched and no plain
              intersect version ran; a 32x32 render is held against the
              same render on the CPU
  5. breakdown  one 1-spp render of the main path under torch.profiler:
              device busy share of the wall, device ops per bounce
              iteration, each kernel's device time
  6. result   a JSON line of the kernels, then the last line
              {"ok": true, "device": {...}}

Tolerances (f32 sums in another order, FMA contraction in the kernel):
hit masks equal except on lanes whose u, v, 1-u-v, t or t-tmax lies
within 1e-5 of a validity boundary (computed in float64); best_t within
rtol 1e-5 where both hit; best_i equal except where the two smallest
candidate t's lie within 1e-5 of each other.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REL = 1e-5          # boundary band of the kernel/plain comparison
TIME_CALLS = 20    # back-to-back calls per timed round
TIME_ROUNDS = 5
SIZE = 512          # image width and height of the main path


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel vs plain version

def check_closest(ik, label, coeffs, phi, tmax, bounds, exact=None):
    """Kernel vs plain closest hit; returns max |t_kernel - t_plain|.
    exact: lanes that must agree with no boundary excuse."""
    import torch
    from tracer_tpu_torch.utils import kernel_cases as kc
    bt, bi = ik.closest_hit(coeffs, phi, tmax, bounds)
    rt, ri = ik.closest_hit_ref(coeffs, phi, tmax, bounds)
    torch.cuda.synchronize()
    edge, tie = kc.boundary_lanes(coeffs, phi, tmax, bounds, rel=REL)
    hk, hr = torch.isfinite(bt), torch.isfinite(rt)
    bad = (hk != hr) & ~edge
    if exact is not None:
        bad |= exact & ((hk != hr) | (bi != ri))
    both = hk & hr
    err = (bt[both] - rt[both]).abs()
    rel_bad = err > REL * rt[both].abs()
    idx_bad = both & ~tie & ~edge & (bi != ri)
    max_err = float(err.max()) if err.numel() else 0.0
    log("kernels", f"closest {label}: lanes={phi.shape[1]} "
        f"hits={int(hk.sum())} edge={int(edge.sum())} tie={int(tie.sum())} "
        f"mask_mismatch={int(bad.sum())} t_rel_fail={int(rel_bad.sum())} "
        f"idx_mismatch={int(idx_bad.sum())} max_abs_err={max_err:.3e}")
    if bad.any() or rel_bad.any() or idx_bad.any():
        raise AssertionError(f"closest_hit_kernel disagrees on {label}")
    return max_err


def check_any(ik, label, coeffs, phi, tmax, bounds, exact=None):
    """Kernel vs plain any hit; returns max |hit_kernel - hit_plain| over
    the lanes outside the boundary band (0 whenever it returns)."""
    import torch
    from tracer_tpu_torch.utils import kernel_cases as kc
    hk = ik.any_hit(coeffs, phi, tmax, bounds)
    hr = ik.any_hit_ref(coeffs, phi, tmax, bounds)
    torch.cuda.synchronize()
    edge, _ = kc.boundary_lanes(coeffs, phi, tmax, bounds, rel=REL)
    bad = (hk != hr) & ~edge
    if exact is not None:
        bad |= exact & (hk != hr)
    log("kernels", f"any {label}: lanes={phi.shape[1]} hits={int(hk.sum())} "
        f"edge={int(edge.sum())} mismatch={int(bad.sum())}")
    if bad.any():
        raise AssertionError(f"any_hit_kernel disagrees on {label}")
    return float((hk[~edge].float() - hr[~edge].float()).abs().max())


def ms_per_call(fn, calls=TIME_CALLS, rounds=TIME_ROUNDS):
    """Median over `rounds` of the CUDA-event time of `calls` back-to-back
    calls divided by `calls`, after two warm-up calls. The operands are
    built before; back to back, the wrapper's host work overlaps the
    previous launch, so the time is the kernel's."""
    import torch
    fn()
    fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def cornell_rays(s):
    """512x512 Cornell camera rays, their first-bounce rays, and 2N shadow
    lanes (light samples, then bounce directions with mostly zero tmax),
    as the main path forms them."""
    import torch
    from tracer_tpu_torch.models import camera as cam_mod
    from tracer_tpu_torch.models import scene as scene_mod
    from tracer_tpu_torch.ops import materials, rng as prng, shapes
    from tracer_tpu_torch.ops import linalg as la
    w, h = s.sub_dims
    n = w * h
    lane = torch.arange(n, device=s.device)
    st = prng.make_streams(s.seed, 1, lane)
    st, wl, _ = cam_mod.sample_wavelength(st, s.cam.conf)
    st, o, d = cam_mod.sample_ray(
        st, s.cam, (w, h), (lane % w).float(),
        float(h) - (lane // w).float() - 1.0)
    o = o.expand(3, n).contiguous()
    inter = scene_mod.closest_interaction(s.scene, shapes.F32_HIGHEST, o, d,
                                          wl)
    st, wi, _, _, _ = materials.sample_dir(st, -d, inter.normal, inter.mat)
    bo, bd = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, wi)
    light = s.scene.light_table[0]
    st, (u, v) = prng.in_triangle(st)
    a, b, c = light[0:3, None], light[3:6, None], light[6:9, None]
    lp = a + u * (b - a) + v * (c - a)
    to_l = lp - inter.pos
    dist = la.v3_norm(to_l)
    so, sd = shapes.mkray_adjust_acne_v(inter.pos, inter.normal, to_l)
    t_l = torch.where(inter.ok, dist - 0.01, 0.0)
    t_b = torch.where(inter.ok & (lane % 8 == 0), 1.0, 0.0)
    shadow_o = torch.cat([so, bo], dim=1)
    shadow_d = torch.cat([sd, bd], dim=1)
    return (o, d), (bo, bd), (shadow_o, shadow_d, torch.cat([t_l, t_b]))


def phase_kernels(ik, intersect, s, device):
    import numpy as np
    import torch
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    dense = s.scene.accel
    cb, co = dense.chunk_bounds, dense.coeffs
    (o, d), (bo, bd), (so, sd, st) = cornell_rays(s)
    errs = {"closest_hit": 0.0, "any_hit": 0.0}
    hi = shapes.F32_HIGHEST

    def upd(k, v):
        errs[k] = max(errs[k], v)

    def v3(a):  # (k, 3) numpy -> (3, k) on the card
        return torch.as_tensor(np.ascontiguousarray(a.T), device=device)

    # (a) Cornell camera and first-bounce rays at 512x512
    phi_cam = intersect.ray_features_t(o, d)
    phi_bnc = intersect.ray_features_t(bo, bd)
    phi_sh = intersect.ray_features_t(so, sd)
    upd("closest_hit", check_closest(ik, "cornell camera", co, phi_cam, hi, cb))
    upd("closest_hit", check_closest(ik, "cornell bounce", co, phi_bnc, hi, cb))
    upd("any_hit", check_any(ik, "cornell shadow 2N", co, phi_sh, st, cb))
    eo, ed = kc.cornell_plane_rays()
    phi_ex = intersect.ray_features_t(v3(eo), v3(ed))
    every = torch.ones(phi_ex.shape[1], dtype=torch.bool, device=device)
    upd("closest_hit", check_closest(ik, "cornell on-plane", co, phi_ex, hi,
                                     cb, exact=every))
    bt, _ = ik.closest_hit(co, phi_ex, hi, cb)
    if not bool(torch.isfinite(bt).all()):
        raise AssertionError("on-plane axis-parallel rays must all hit")

    # (b) 1,100 triangles, 5 chunks of 256, 320 random rays and the
    # axis-parallel rays on every chunk's bound planes
    tris, ro_np, rdir_np = kc.random_case(1100, 320)
    rd = intersect.build_dense(torch.as_tensor(tris, device=device),
                               pad_to=256)
    if rd.chunk_bounds.shape[0] != 5:
        raise AssertionError(f"expected 5 chunks, got {rd.chunk_bounds.shape[0]}")
    po, pd = kc.on_plane_rays(rd.chunk_bounds.cpu().numpy())
    ro_np = np.concatenate([ro_np, po])
    rdir_np = np.concatenate([rdir_np, pd])
    ro, rdir = v3(ro_np), v3(rdir_np)
    phi_r = intersect.ray_features_t(ro, rdir)
    n = phi_r.shape[1]
    lane_t = torch.as_tensor(
        np.where(np.arange(n) % 3 == 0, 0.0,
                 np.where(np.arange(n) % 3 == 1, 4.0, 1e30)).astype(np.float32),
        device=device)
    for label, tm in (("random5 tmax=inf", hi), ("random5 tmax=4", 4.0),
                      ("random5 per-lane tmax", lane_t)):
        upd("closest_hit", check_closest(ik, label, rd.coeffs, phi_r, tm,
                                         rd.chunk_bounds))
        upd("any_hit", check_any(ik, label, rd.coeffs, phi_r, tm,
                                 rd.chunk_bounds))

    # (c) the exact brute-force oracle on (b)
    ok, t, idx, _, _, _ = intersect.closest_hit(rd, hi, ro, rdir)
    bh, btt, bii = intersect.closest_hit_bruteforce(
        torch.as_tensor(tris, device=device), hi,
        torch.as_tensor(ro_np, device=device),
        torch.as_tensor(rdir_np, device=device))
    edge, tie = kc.boundary_lanes(rd.coeffs, phi_r, hi, rd.chunk_bounds,
                                  rel=REL)
    mapped = rd.perm[idx.clamp_min(0).long()]
    bad = ((ok != bh) & ~edge) | (ok & bh & ~tie & ~edge & (mapped != bii))
    both = ok & bh
    oracle_err = float((t[both] - btt[both]).abs().max())
    t_bad = (t[both] - btt[both]).abs() > REL * btt[both].abs() + 1e-6
    log("kernels", f"oracle random5: hits={int(ok.sum())} "
        f"mismatch={int(bad.sum())} t_fail={int(t_bad.sum())} "
        f"max_abs_err={oracle_err:.3e}")
    if bad.any() or t_bad.any():
        raise AssertionError("closest_hit disagrees with the brute-force oracle")

    # timing at the Cornell shapes: closest on first-bounce rays, any on 2N
    times = {
        "closest_hit": (
            ms_per_call(lambda: ik.closest_hit(co, phi_bnc, hi, cb)),
            ms_per_call(lambda: ik.closest_hit_ref(co, phi_bnc, hi, cb))),
        "any_hit": (
            ms_per_call(lambda: ik.any_hit(co, phi_sh, st, cb)),
            ms_per_call(lambda: ik.any_hit_ref(co, phi_sh, st, cb))),
    }
    for k, (ms, plain) in times.items():
        log("kernels", f"time {k}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(median of {TIME_ROUNDS} rounds of {TIME_CALLS} back-to-back "
            f"calls, lanes "
            f"{phi_bnc.shape[1] if k == 'closest_hit' else phi_sh.shape[1]})")
    return errs, times


# ---------------------------------------------------------------------------
# main path

def load_cornell():
    """CornellBox-Original.obj from $TRACER_ASSETS when it is there, else
    the procedural Cornell box (as bench.py chooses)."""
    assets = os.environ.get("TRACER_ASSETS")
    path = os.path.join(assets, "CornellBox-Original.obj") if assets else None
    if path and os.path.exists(path):
        from tracer_tpu_torch.utils.objloader import load_obj
        return load_obj(path), "CornellBox-Original.obj"
    from tracer_tpu_torch.utils.testscenes import cornell_like
    return cornell_like(), "procedural cornell_like"


def check_image(img, label):
    import torch
    if img.shape[-1] != 3 or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: image not finite (h, w, 3)")
    left, right = img[:, :10], img[:, -10:]
    lr, lg = float(left[..., 0].mean()), float(left[..., 1].mean())
    rr, rg = float(right[..., 0].mean()), float(right[..., 1].mean())
    log("main", f"{label}: max={float(img.max()):.3f} "
        f"mean={float(img.mean()):.4f} left r/g={lr:.4f}/{lg:.4f} "
        f"right r/g={rr:.4f}/{rg:.4f}")
    if not float(img.max()) > 0.5:
        raise AssertionError(f"{label}: light not visible")
    if not lr > 1.5 * lg or not (rg - rr) > (lg - lr) + 0.01:
        raise AssertionError(f"{label}: red left / green right tint missing")


def phase_main(T, integrator, ik, scene_arrays, card, device):
    import torch
    tris, tm, mats = scene_arrays
    s = T.init(0, SIZE, SIZE, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8),
               device=device)
    w, h = s.sub_dims
    T.sample_n_frames(s, 1)   # warm-up: first launches, allocator
    torch.cuda.synchronize()

    ik.reset_counts()
    t0 = time.perf_counter()
    out = integrator.render_frames(s.seed, s.nonce + 1, s.scene, s.cam,
                                   s.ambience, w, h, s.transmitter_kind, 16,
                                   s.render_mode)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rays = out["rays_traced"]
    img = T.sample_n_frames(s, 17)
    torch.cuda.synchronize()
    s2 = s
    for _ in range(3):
        s2, argb = T.step_render(s2)
        if tuple(argb.shape) != (SIZE, SIZE) or argb.dtype != torch.uint32:
            raise AssertionError(f"step_render gave {argb.dtype} "
                                 f"{tuple(argb.shape)}")
    torch.cuda.synchronize()
    launches = dict(ik.launches)
    plain = dict(ik.plain_calls)

    log("main", f"render {SIZE}x{SIZE} 16 spp: {secs:.3f} s, rays_traced={rays} "
        f"(3 x live lanes per bounce), {rays / secs / 1e6:.2f} Mrays/s "
        f"on {card}")
    log("main", f"launches={launches} plain_calls={plain}")
    if not torch.equal(img, out["img"]):
        raise AssertionError("sample_n_frames(s, 17) differs from the timed "
                             "16-spp render of the same streams")
    check_image(img, f"sample_n_frames {SIZE}x{SIZE} 16spp")
    if min(launches.values()) <= 0 or max(plain.values()) != 0:
        raise AssertionError("the main path did not run through the kernels")
    argb0 = int(argb[SIZE // 2, SIZE // 2])
    if argb0 >> 24 != 0xFF:
        raise AssertionError("ARGB alpha byte is not 0xFF")
    return s, launches


def busy_us(spans):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def phase_breakdown(integrator, ik, s, card):
    """Where the time of one 1-spp render of the main path goes.
    torch.profiler traces the card; the device is busy over the union of
    its kernel and copy intervals, each taken once, and the share is of
    the host-clock wall of the same profiled render (the profiler's own
    host cost lengthens that wall, so the share is a lower bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    w, h = s.sub_dims

    def render():
        integrator.render_frames(s.seed, s.nonce + 1, s.scene, s.cam,
                                 s.ambience, w, h, s.transmitter_kind, 1,
                                 s.render_mode)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    render()
    plain_wall = time.perf_counter() - t0
    n0 = ik.launches["closest_hit"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        wall = time.perf_counter() - t0
    iters = ik.launches["closest_hit"] - n0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e6
    log("breakdown", f"1-spp {w}x{h} render under torch.profiler: wall "
        f"{wall:.4f} s ({plain_wall:.4f} s unprofiled), {iters} bounce "
        f"iterations, {len(dev)} device ops ({len(dev) / iters:.0f} per "
        f"iteration), device busy {busy:.4f} s = {100 * busy / wall:.1f}% of "
        f"the profiled wall, on {card}")
    for k in ("closest_hit", "any_hit"):
        ks = [e.time_range.elapsed_us() for e in dev if f"{k}_kernel" in e.name]
        if len(ks) != iters:
            raise AssertionError(f"{len(ks)} {k}_kernel spans in the trace, "
                                 f"{iters} bounce iterations")
        log("breakdown", f"{k}_kernel: {len(ks)} launches, "
            f"{sum(ks) / 1e3:.3f} ms on the device "
            f"({sum(ks) / len(ks) / 1e3:.4f} ms each), "
            f"{100 * sum(ks) / 1e6 / busy:.1f}% of device busy time")


def phase_reference(T, scene_arrays, device):
    """A 32x32, 8-spp render on the card against the same render on the
    CPU, where the plain versions stand in for the kernels."""
    import torch
    tris, tm, mats = scene_arrays
    imgs = []
    for dev in (device, "cpu"):
        s = T.init(0, 32, 32, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8),
                   device=dev)
        imgs.append(T.sample_n_frames(s, 9).cpu())
    close = torch.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4)
    frac = float(close.all(dim=-1).float().mean())
    m0, m1 = float(imgs[0].mean()), float(imgs[1].mean())
    log("main", f"32x32 8spp card vs cpu: pixels within rtol 1e-3 = "
        f"{frac:.4f}, means {m0:.5f} / {m1:.5f}")
    if frac < 0.99 or abs(m0 - m1) > 1e-2 * abs(m1):
        raise AssertionError("card render disagrees with the CPU render")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import tracer_tpu_torch as T
        from tracer_tpu_torch.engine import integrator
        from tracer_tpu_torch.ops import intersect, intersect_kernel as ik
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    card = card_line()
    log("device", f"torch.cuda: {torch.cuda.get_device_name(0)}; "
        f"count={torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    print(card, flush=True)

    ik.build()
    info = ik.build_info()
    log("build", f"nvcc build of csrc/intersect.cu: {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build", line.strip())

    scene_arrays, scene_name = load_cornell()
    s = T.init(0, SIZE, SIZE, 0, *scene_arrays, cam_origin=(0.0, 0.8, 1.8),
               device=device)
    log("kernels", f"scene {scene_name}: {s.scene.tris.shape[0]} triangles, "
        f"{s.scene.accel.chunk_bounds.shape[0]} chunk(s) of "
        f"{s.scene.accel.coeffs.shape[1] // s.scene.accel.chunk_bounds.shape[0]}")
    errs, times = phase_kernels(ik, intersect, s, device)
    del s
    s, launches = phase_main(T, integrator, ik, scene_arrays, card, device)
    phase_reference(T, scene_arrays, device)
    phase_breakdown(integrator, ik, s, card)
    del s

    replaces = {
        "closest_hit": "tracer_tpu/ops/pallas/intersect_kernel.py:429",
        "any_hit": "tracer_tpu/ops/pallas/intersect_kernel.py:497",
    }
    kernels = [{"name": f"{k}_kernel", "route": "cuda",
                "source": "tracer_tpu_torch/csrc/intersect.cu",
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in ("closest_hit", "any_hit")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
