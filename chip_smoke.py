#!/usr/bin/env python3
"""Smoke test of tracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout. Phases, each printed on its own line;
any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc-builds csrc/intersect.cu from the checkout
  3. kernels  the hand kernels against their plain PyTorch versions on
              the card: Cornell camera and first-bounce rays at 512x512,
              a 1,100-triangle 5-chunk random scene with on-plane
              axis-parallel rays and per-lane tmax (also with
              max_sched=3, g = 2 with a padded superchunk, in both
              variants), and the brute-force oracle; then each resident
              kernel's median time beside its plain version's at the
              Cornell shapes (CUDA events)
  4. main     the port's main path: init a 512x512 Cornell box, render
              16 spp (sample_n_frames(s, 17)), 3 x step_render; checks
              the image and that every kernel launched and no plain
              intersect version ran; a 32x32 render is held against the
              same render on the CPU
  5. breakdown  one 1-spp render of the main path under torch.profiler:
              device busy share of the wall, device ops per bounce
              iteration, each kernel's device time
  6. bigscene the big-scene path on subdivisions of the Cornell box
              (the same surfaces and materials): all four kernels on
              subdivide(cornell_like, 5) (22,528 triangles, 88 chunks)
              and on cornell-sub6 = subdivide(cornell_like, 6) (90,112
              triangles, 352 chunks, streamed), each resident and
              streamed, with and without the ray permutation, against
              the plain version on a strided subset of 32,768 lanes; a
              hit-for-hit check of 8,192 rays on subdivide(cornell_like,
              8) (1,441,792 triangles); the 512x512 16-spp render of
              cornell-sub6 through init / render_frames / sample_n_frames,
              whose image must pass the Cornell checks and lie within 3%
              of the Cornell image's mean; the breakdown of one 1-spp
              cornell-sub6 render and its chunk schedule statistics; each
              of the four kernels timed at cornell-sub6's shapes
  7. result   a JSON line of the kernels, then the last line
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
SUBSET = 32_768     # lanes of a big-scene kernel result held to the plain
MEAN_REL = 0.03     # cornell-sub6 image mean against the Cornell image's
# subdivision levels of cornell_like: the resident multi-chunk scene, the
# slice's scene (cornell-sub6) and the hit-for-hit check
RESIDENT_LEVELS, SLICE_LEVELS, CHECK_LEVELS = 5, 6, 8
CAM_ORIGIN = (0.0, 0.8, 1.8)
VARIANTS = ("closest_hit", "closest_hit_streamed", "any_hit",
            "any_hit_streamed")
REPLACES = {
    "closest_hit": "tracer_tpu/ops/pallas/intersect_kernel.py:429",
    "closest_hit_streamed": "tracer_tpu/ops/pallas/intersect_kernel.py:589",
    "any_hit": "tracer_tpu/ops/pallas/intersect_kernel.py:497",
    "any_hit_streamed": "tracer_tpu/ops/pallas/intersect_kernel.py:704",
}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def variant(query, stream):
    return f"{query}_hit_streamed" if stream else f"{query}_hit"


# ---------------------------------------------------------------------------
# kernel vs plain version

def compare_closest(phase, label, got, ref, edge_tie, exact=None):
    """Kernel (best_t, best_i) against the plain version's on the same
    lanes; returns max |t_kernel - t_plain|. exact: lanes that must agree
    with no boundary excuse."""
    import torch
    (bt, bi), (rt, ri), (edge, tie) = got, ref, edge_tie
    torch.cuda.synchronize()
    hk, hr = torch.isfinite(bt), torch.isfinite(rt)
    bad = (hk != hr) & ~edge
    if exact is not None:
        bad |= exact & ((hk != hr) | (bi != ri))
    both = hk & hr
    err = (bt[both] - rt[both]).abs()
    rel_bad = err > REL * rt[both].abs()
    idx_bad = both & ~tie & ~edge & (bi != ri)
    max_err = float(err.max()) if err.numel() else 0.0
    log(phase, f"closest {label}: lanes={bt.shape[0]} "
        f"hits={int(hk.sum())} edge={int(edge.sum())} tie={int(tie.sum())} "
        f"mask_mismatch={int(bad.sum())} t_rel_fail={int(rel_bad.sum())} "
        f"idx_mismatch={int(idx_bad.sum())} max_abs_err={max_err:.3e}")
    if bad.any() or rel_bad.any() or idx_bad.any():
        raise AssertionError(f"closest-hit kernel disagrees on {label}")
    return max_err


def compare_any(phase, label, hk, hr, edge, exact=None):
    """Kernel hits against the plain version's; returns max |hit_kernel -
    hit_plain| over the lanes outside the boundary band (0 whenever it
    returns)."""
    import torch
    torch.cuda.synchronize()
    bad = (hk != hr) & ~edge
    if exact is not None:
        bad |= exact & (hk != hr)
    log(phase, f"any {label}: lanes={hk.shape[0]} hits={int(hk.sum())} "
        f"edge={int(edge.sum())} mismatch={int(bad.sum())}")
    if bad.any():
        raise AssertionError(f"any-hit kernel disagrees on {label}")
    return float((hk[~edge].float() - hr[~edge].float()).abs().max())


def check_closest(ik, label, coeffs, phi, tmax, bounds, exact=None, **kw):
    from tracer_tpu_torch.utils import kernel_cases as kc
    return compare_closest(
        "kernels", label, ik.closest_hit(coeffs, phi, tmax, bounds, **kw),
        ik.closest_hit_ref(coeffs, phi, tmax, bounds),
        kc.boundary_lanes(coeffs, phi, tmax, bounds, rel=REL), exact)


def check_any(ik, label, coeffs, phi, tmax, bounds, exact=None, **kw):
    from tracer_tpu_torch.utils import kernel_cases as kc
    edge, _ = kc.boundary_lanes(coeffs, phi, tmax, bounds, rel=REL)
    return compare_any("kernels", label,
                       ik.any_hit(coeffs, phi, tmax, bounds, **kw),
                       ik.any_hit_ref(coeffs, phi, tmax, bounds), edge, exact)


def ms_per_call(fn, calls=TIME_CALLS, rounds=TIME_ROUNDS):
    """Median over `rounds` of the CUDA-event time of `calls` back-to-back
    calls divided by `calls`, after two warm-up calls. The operands are
    built before; back to back, the wrapper's host work overlaps the
    previous launch, so the time is the kernel's (with the schedule the
    wrapper builds for it)."""
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


def phase_kernels(ik, intersect, s, device, errs):
    import numpy as np
    import torch
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    dense = s.scene.accel
    cb, co = dense.chunk_bounds, dense.coeffs
    (o, d), (bo, bd), (so, sd, st) = kc.render_rays(s)
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

    # (b) 1,100 triangles, 5 chunks of 256, 320 random rays, the
    # axis-parallel rays on every chunk's bound planes and two rays with a
    # NaN origin or direction, which must miss; each variant, and with
    # max_sched=3 (g = 2, the last superchunk padded)
    tris, ro_np, rdir_np = kc.random_case(1100, 320)
    rd = intersect.build_dense(torch.as_tensor(tris, device=device),
                               pad_to=256)
    if rd.chunk_bounds.shape[0] != 5:
        raise AssertionError(f"expected 5 chunks, got {rd.chunk_bounds.shape[0]}")
    po, pd = kc.on_plane_rays(rd.chunk_bounds.cpu().numpy())
    nan = float("nan")
    ro_np = np.concatenate([ro_np, po, [[nan, 0, 4], [0, 0, 4]]]).astype(
        np.float32)
    rdir_np = np.concatenate([rdir_np, pd, [[0, 0, -1], [nan, 0, -1]]]
                             ).astype(np.float32)
    ro, rdir = v3(ro_np), v3(rdir_np)
    phi_r = intersect.ray_features_t(ro, rdir)
    n = phi_r.shape[1]
    nan_lanes = torch.arange(n, device=device) >= n - 2
    lane_t = torch.as_tensor(
        np.where(np.arange(n) % 3 == 0, 0.0,
                 np.where(np.arange(n) % 3 == 1, 4.0, 1e30)).astype(np.float32),
        device=device)
    for label, tm in (("random5 tmax=inf", hi), ("random5 tmax=4", 4.0),
                      ("random5 per-lane tmax", lane_t)):
        for stream in (False, True):
            for max_sched in (ik.MAX_SCHED, 3):
                kw = {"stream": stream, "max_sched": max_sched}
                tag = f"{label} stream={stream} max_sched={max_sched}"
                upd(variant("closest", stream),
                    check_closest(ik, tag, rd.coeffs, phi_r, tm,
                                  rd.chunk_bounds, exact=nan_lanes, **kw))
                upd(variant("any", stream),
                    check_any(ik, tag, rd.coeffs, phi_r, tm, rd.chunk_bounds,
                              exact=nan_lanes, **kw))

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
    if bad.any() or t_bad.any() or ok[nan_lanes].any():
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
        log("kernels", f"time {k} at the Cornell shapes: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms (median of {TIME_ROUNDS} rounds of "
            f"{TIME_CALLS} back-to-back calls, lanes "
            f"{phi_bnc.shape[1] if k == 'closest_hit' else phi_sh.shape[1]})")


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


def cornell_sub(levels):
    """subdivide(cornell_like, levels): the procedural Cornell box with
    22 * 4**levels triangles, its materials unchanged."""
    from tracer_tpu_torch.utils.testscenes import cornell_like, subdivide
    tris, tm, mats = cornell_like()
    return (*subdivide(tris, tm, levels=levels), mats)


def check_image(img, label, phase="main"):
    import torch
    if img.shape[-1] != 3 or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: image not finite (h, w, 3)")
    left, right = img[:, :10], img[:, -10:]
    lr, lg = float(left[..., 0].mean()), float(left[..., 1].mean())
    rr, rg = float(right[..., 0].mean()), float(right[..., 1].mean())
    log(phase, f"{label}: max={float(img.max()):.3f} "
        f"mean={float(img.mean()):.4f} left r/g={lr:.4f}/{lg:.4f} "
        f"right r/g={rr:.4f}/{rg:.4f}")
    if not float(img.max()) > 0.5:
        raise AssertionError(f"{label}: light not visible")
    if not lr > 1.5 * lg or not (rg - rr) > (lg - lr) + 0.01:
        raise AssertionError(f"{label}: red left / green right tint missing")


def render_16spp(T, integrator, ik, s, phase, card):
    """Warm up, set the counts to 0, time render_frames at 16 spp, and
    check that sample_n_frames(s, 17) gives the same image. Returns
    (image, launches, plain_calls) of that run."""
    import torch
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
    launches, plain = dict(ik.launches), dict(ik.plain_calls)
    log(phase, f"render {w}x{h} 16 spp: {secs:.3f} s, rays_traced={rays} "
        f"(3 x live lanes per bounce), {rays / secs / 1e6:.2f} Mrays/s "
        f"on {card}")
    if not torch.equal(img, out["img"]):
        raise AssertionError("sample_n_frames(s, 17) differs from the timed "
                             "16-spp render of the same streams")
    return img, launches, plain


def phase_main(T, integrator, ik, scene_arrays, card, device):
    import torch
    tris, tm, mats = scene_arrays
    s = T.init(0, SIZE, SIZE, 0, tris, tm, mats, cam_origin=CAM_ORIGIN,
               device=device)
    img, _, _ = render_16spp(T, integrator, ik, s, "main", card)
    s2 = s
    for _ in range(3):
        s2, argb = T.step_render(s2)
        if tuple(argb.shape) != (SIZE, SIZE) or argb.dtype != torch.uint32:
            raise AssertionError(f"step_render gave {argb.dtype} "
                                 f"{tuple(argb.shape)}")
    torch.cuda.synchronize()
    launches = dict(ik.launches)
    plain = dict(ik.plain_calls)
    log("main", f"launches={launches} plain_calls={plain}")
    check_image(img, f"sample_n_frames {SIZE}x{SIZE} 16spp")
    if (launches["closest_hit"] <= 0 or launches["any_hit"] <= 0
            or max(plain.values()) != 0):
        raise AssertionError("the main path did not run through the kernels")
    argb0 = int(argb[SIZE // 2, SIZE // 2])
    if argb0 >> 24 != 0xFF:
        raise AssertionError("ARGB alpha byte is not 0xFF")
    return s, launches, float(img.mean())


def busy_us(spans):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def phase_breakdown(integrator, ik, s, card, names, phase="breakdown"):
    """Where the time of one 1-spp render goes, for the kernels `names`
    (closest first) that the render launches once per bounce iteration.
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
    n0 = ik.launches[names[0]]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        wall = time.perf_counter() - t0
    iters = ik.launches[names[0]] - n0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e6
    log(phase, f"1-spp {w}x{h} render under torch.profiler: wall "
        f"{wall:.4f} s ({plain_wall:.4f} s unprofiled), {iters} bounce "
        f"iterations, {len(dev)} device ops ({len(dev) / iters:.0f} per "
        f"iteration), device busy {busy:.4f} s = {100 * busy / wall:.1f}% of "
        f"the profiled wall, on {card}")
    for k in names:
        ks = [e.time_range.elapsed_us() for e in dev if f"{k}_kernel" in e.name]
        if len(ks) != iters:
            raise AssertionError(f"{len(ks)} {k}_kernel spans in the trace, "
                                 f"{iters} bounce iterations")
        log(phase, f"{k}_kernel: {len(ks)} launches, "
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
        s = T.init(0, 32, 32, 0, tris, tm, mats, cam_origin=CAM_ORIGIN,
                   device=dev)
        imgs.append(T.sample_n_frames(s, 9).cpu())
    close = torch.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4)
    frac = float(close.all(dim=-1).float().mean())
    m0, m1 = float(imgs[0].mean()), float(imgs[1].mean())
    log("main", f"32x32 8spp card vs cpu: pixels within rtol 1e-3 = "
        f"{frac:.4f}, means {m0:.5f} / {m1:.5f}")
    if frac < 0.99 or abs(m0 - m1) > 1e-2 * abs(m1):
        raise AssertionError("card render disagrees with the CPU render")


# ---------------------------------------------------------------------------
# big scenes

def strided(n, device, k=SUBSET):
    """A fixed strided subset of k of n lanes (all of them when n <= k)."""
    import torch
    return torch.arange(0, n, max(1, n // k), device=device)[:k]


def check_all_variants(ik, intersect, label, dense, phi, tmax, query, errs,
                       streams=(False, True), perms=("off", "auto")):
    """The kernels of `query` at full width, each stream and perm setting,
    against the plain version on a strided subset of the lanes."""
    import torch
    from tracer_tpu_torch.utils import kernel_cases as kc
    n = phi.shape[1]
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    sub = strided(n, phi.device)
    phi_s = phi[:, sub].contiguous()
    tm_s = tmax[sub] if tmax.dim() else tmax
    co, cb = dense.coeffs, dense.chunk_bounds
    edge, tie = kc.boundary_lanes(co, phi_s, tm_s, cb, rel=REL)
    if query == "closest":
        ref = ik.closest_hit_ref(co, phi_s, tm_s, cb)
    else:
        ref = ik.any_hit_ref(co, phi_s, tm_s, cb)
    for stream in streams:
        for perm in perms:
            tag = (f"{label} stream={stream} perm={perm} "
                   f"({sub.shape[0]} of {n} lanes)")
            name = variant(query, ik.streamed_variant(co.shape[1], stream))
            before = ik.launches[name]
            if query == "closest":
                bt, bi = intersect.closest_hit_phi(dense, tmax, phi,
                                                   perm=perm, stream=stream)
                err = compare_closest("bigscene", tag, (bt[sub], bi[sub]),
                                      ref, (edge, tie))
            else:
                hit = intersect.any_hit_phi(dense, tmax, phi, perm=perm,
                                            stream=stream)
                err = compare_any("bigscene", tag, hit[sub], ref, edge)
            if ik.launches[name] != before + 1:
                raise AssertionError(f"{tag} did not launch {name}_kernel")
            errs[name] = max(errs[name], err)
    return ref


def phase_big_kernels(T, ik, intersect, device, errs):
    """(1) all four kernels on subdivide(cornell_like, 5) and on
    cornell-sub6 at the main path's 512x512 shapes. Returns the states."""
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    states = {}
    for levels in (RESIDENT_LEVELS, SLICE_LEVELS):
        s = T.init(0, SIZE, SIZE, 0, *cornell_sub(levels),
                   cam_origin=CAM_ORIGIN, device=device)
        dense = s.scene.accel
        n_chunks = dense.chunk_bounds.shape[0]
        t_pad = dense.coeffs.shape[1]
        g = -(-n_chunks // ik.MAX_SCHED)
        log("bigscene", f"subdivide(cornell_like, {levels}): "
            f"{s.scene.tris.shape[0]} triangles, {n_chunks} chunks of "
            f"{t_pad // n_chunks}, g = {g}, {-(-n_chunks // g)} superchunks, "
            f"{dense.coeffs.numel() * 4 / 1e6:.1f} MB of coefficients, "
            f"{'streamed' if ik.streamed_variant(t_pad) else 'resident'} "
            f"by default, {s.scene.lights.count} light triangles")
        (o, d), (bo, bd), (so, sd, st) = kc.render_rays(s)
        hi = shapes.F32_HIGHEST
        for label, oo, dd in (("camera", o, d), ("first-bounce", bo, bd)):
            check_all_variants(ik, intersect, f"sub{levels} {label}", dense,
                               intersect.ray_features_t(oo, dd), hi,
                               "closest", errs)
        check_all_variants(ik, intersect, f"sub{levels} shadow 2N", dense,
                           intersect.ray_features_t(so, sd), st, "any", errs)
        states[levels] = s
    return states


def phase_big_check(ik, intersect, device, errs):
    """(2) hit for hit on subdivide(cornell_like, 8): 1,441,792 triangles,
    8,192 bigscene_rays, K2/K4 (stream=None) and K1/K3 (stream=False)
    with perm="auto", against the plain version on every lane."""
    import torch
    from tracer_tpu_torch.utils import kernel_cases as kc
    tris, _, _ = cornell_sub(CHECK_LEVELS)
    t0 = time.perf_counter()
    dense = intersect.build_dense(torch.as_tensor(tris, device=device))
    torch.cuda.synchronize()
    n_chunks = dense.chunk_bounds.shape[0]
    g = -(-n_chunks // ik.MAX_SCHED)
    log("bigscene", f"subdivide(cornell_like, {CHECK_LEVELS}): "
        f"{tris.shape[0]} triangles, "
        f"{n_chunks} chunks, g = {g}, {dense.coeffs.numel() * 4 / 1e6:.1f} MB "
        f"of coefficients, build_dense {time.perf_counter() - t0:.2f} s")
    if tris.shape[0] != 22 * 4 ** CHECK_LEVELS or n_chunks != 22 * 4 ** (
            CHECK_LEVELS - 4):
        raise AssertionError("unexpected size of the subdivided scene")
    o, d = kc.bigscene_rays(tris, 8192, 0)
    phi = intersect.ray_features_t(
        torch.as_tensor(o.T.copy(), device=device),
        torch.as_tensor(d.T.copy(), device=device))
    for query, tmax in (("closest", 1e30), ("any", 4.0)):
        ref = check_all_variants(ik, intersect,
                                 f"sub{CHECK_LEVELS} {query} tmax={tmax:g}",
                                 dense, phi, tmax, query, errs,
                                 streams=(None, False), perms=("auto",))
        hit = torch.isfinite(ref[0]) if query == "closest" else ref
        hits = int(hit.sum())
        if hits < hit.shape[0] // 4:
            raise AssertionError(f"degenerate ray batch: {hits} {query} hits")


def schedule_stats(ik, intersect, s):
    """(4b) Entries per CUDA block of the chunk schedule (superchunks of
    g chunks) for the first-bounce closest query and the shadow query,
    without and with the permutation the main path applies."""
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    dense = s.scene.accel
    cb = dense.chunk_bounds
    _, (bo, bd), (so, sd, st) = kc.render_rays(s)
    for label, phi, tmax, dead_first in (
            ("first-bounce closest", intersect.ray_features_t(bo, bd),
             shapes.F32_HIGHEST, False),
            ("shadow 2N", intersect.ray_features_t(so, sd), st, True)):
        for perm in ("off", "odmorton"):
            p, t = phi, tmax
            if perm != "off":
                idx = intersect.lane_order(phi, tmax, cb, perm,
                                           dead_first=dead_first)
                p = phi[:, idx]
                t = tmax[idx] if dead_first else tmax
            g, sb, _, count = ik.walk_schedule(p, t, cb)
            c = count.float()
            log("bigscene", f"schedule {label} perm={perm}: {c.shape[0]} "
                f"blocks of {ik.BLOCK} lanes, entries per block mean "
                f"{float(c.mean()):.2f} max {int(c.max())} of {sb.shape[0]} "
                f"superchunks (g = {g}), blocks with none "
                f"{int((c == 0).sum())}")


def phase_big_timing(ik, intersect, s, card):
    """(5) each of the four kernels on cornell-sub6's first-bounce rays
    (closest) and 2N shadow lanes (any), on the lanes as the main path
    orders them (perm="auto": odmorton), beside the plain version."""
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    dense = s.scene.accel
    co, cb = dense.coeffs, dense.chunk_bounds
    _, (bo, bd), (so, sd, st) = kc.render_rays(s)
    hi = shapes.F32_HIGHEST
    phi_b = intersect.ray_features_t(bo, bd)
    phi_s = intersect.ray_features_t(so, sd)
    idx_b = intersect.lane_order(phi_b, hi, cb, "odmorton")
    idx_s = intersect.lane_order(phi_s, st, cb, "odmorton", dead_first=True)
    phi_b, phi_s, st = phi_b[:, idx_b], phi_s[:, idx_s], st[idx_s]
    plain = {
        "closest": ms_per_call(lambda: ik.closest_hit_ref(co, phi_b, hi, cb),
                               calls=1, rounds=3),
        "any": ms_per_call(lambda: ik.any_hit_ref(co, phi_s, st, cb),
                           calls=1, rounds=3)}
    times = {}
    for stream in (False, True):
        times[variant("closest", stream)] = (
            ms_per_call(lambda: ik.closest_hit(co, phi_b, hi, cb,
                                               stream=stream)),
            plain["closest"],
            f"{phi_b.shape[1]} first-bounce rays of cornell-sub6, odmorton "
            f"order")
        times[variant("any", stream)] = (
            ms_per_call(lambda: ik.any_hit(co, phi_s, st, cb, stream=stream)),
            plain["any"],
            f"{phi_s.shape[1]} shadow lanes (2N) of cornell-sub6, odmorton "
            f"order, dead lanes first")
    for k, (ms, pms, shape) in times.items():
        log("bigscene", f"time {k}: kernel {ms:.4f} ms (median of "
            f"{TIME_ROUNDS} rounds of {TIME_CALLS} back-to-back calls, the "
            f"wrapper's schedule build included), plain {pms:.4f} ms "
            f"(median of 3 single calls), {shape}, on {card}")
    return times


def phase_bigscene(T, integrator, ik, intersect, card, device, errs,
                   cornell_mean):
    import torch
    states = phase_big_kernels(T, ik, intersect, device, errs)
    del states[RESIDENT_LEVELS]
    torch.cuda.empty_cache()
    phase_big_check(ik, intersect, device, errs)
    torch.cuda.empty_cache()

    # (3) the slice's render: cornell-sub6 through the entry points
    s = states[SLICE_LEVELS]
    img, launches, plain = render_16spp(T, integrator, ik, s, "bigscene",
                                        card)
    log("bigscene", f"cornell-sub6 launches={launches} plain_calls={plain}")
    check_image(img, f"cornell-sub6 sample_n_frames {SIZE}x{SIZE} 16spp",
                phase="bigscene")
    mean = float(img.mean())
    log("bigscene", f"cornell-sub6 image mean {mean:.5f}, Cornell image mean "
        f"{cornell_mean:.5f}, relative difference "
        f"{abs(mean - cornell_mean) / cornell_mean:.4f} (limit {MEAN_REL})")
    if abs(mean - cornell_mean) > MEAN_REL * cornell_mean:
        raise AssertionError("the cornell-sub6 image mean is not the "
                             "Cornell image's")
    if (launches["closest_hit_streamed"] <= 0
            or launches["any_hit_streamed"] <= 0
            or max(plain.values()) != 0):
        raise AssertionError("the cornell-sub6 render did not run through "
                             "the streamed kernels alone")

    # (4) breakdown and schedule statistics of one 1-spp render
    phase_breakdown(integrator, ik, s, card,
                    ("closest_hit_streamed", "any_hit_streamed"),
                    phase="bigscene")
    schedule_stats(ik, intersect, s)
    # (5) timing of the four kernels at cornell-sub6's shapes
    return launches, phase_big_timing(ik, intersect, s, card)


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
    t_start = time.perf_counter()

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

    errs = dict.fromkeys(VARIANTS, 0.0)
    scene_arrays, scene_name = load_cornell()
    s = T.init(0, SIZE, SIZE, 0, *scene_arrays, cam_origin=CAM_ORIGIN,
               device=device)
    log("kernels", f"scene {scene_name}: {s.scene.tris.shape[0]} triangles, "
        f"{s.scene.accel.chunk_bounds.shape[0]} chunk(s) of "
        f"{s.scene.accel.coeffs.shape[1] // s.scene.accel.chunk_bounds.shape[0]}")
    phase_kernels(ik, intersect, s, device, errs)
    del s
    s, launches, cornell_mean = phase_main(T, integrator, ik, scene_arrays,
                                           card, device)
    phase_reference(T, scene_arrays, device)
    phase_breakdown(integrator, ik, s, card, ("closest_hit", "any_hit"))
    del s
    torch.cuda.empty_cache()
    big_launches, times = phase_bigscene(T, integrator, ik, intersect, card,
                                         device, errs, cornell_mean)
    launches.update({k: big_launches[k] for k in
                     ("closest_hit_streamed", "any_hit_streamed")})

    kernels = [{"name": f"{k}_kernel", "route": "cuda",
                "source": "tracer_tpu_torch/csrc/intersect.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1], "timed_at": times[k][2]}
               for k in VARIANTS]
    if min(k["launches"] for k in kernels) <= 0:
        raise AssertionError("a kernel of the path was not launched")
    log("result", f"chip_smoke ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
