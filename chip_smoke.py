#!/usr/bin/env python3
"""Smoke test of tracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout. Phases, each printed on its own line;
any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc-builds csrc/intersect.cu and csrc/recip.cu from the
              checkout into one library; counts each kernel's shared-
              memory load instructions in cuobjdump -sass of it (those of
              K1, K2, K3 and K4 are their scan loops', one triangle per
              iteration: 10 LDS.128 in each copy of the loop the compiler
              emitted, and no narrower load, or the phase fails); K1's
              registers and spills as ptxas printed them
  3. kernels  the hand kernels against their plain PyTorch versions on
              the card: Cornell camera and first-bounce rays at 512x512,
              a 1,100-triangle 5-chunk random scene with on-plane
              axis-parallel rays and per-lane tmax (also with
              max_sched=3, g = 2 with a padded superchunk, in both
              variants), and the brute-force oracle; K1 with a mixed
              per-lane tmax (live, 0 and NaN lanes, which must give
              (+inf, 0)) against its plain version; K1 against the exact
              yardstick kernel (closest_hit_exact_kernel: block-granular,
              row-major, the divide on every triangle) on every Cornell
              first-bounce ray, best_t bit for bit; then each resident
              kernel's and the exact kernel's median time, wrapper call
              and launch alone, beside its plain version's and its bound
              at the Cornell shapes, where the main path launches it
              (CUDA events); K3 against the exact kernel's hits on every
              Cornell shadow lane
  4. main     the port's main path: init a 512x512 Cornell box, render
              16 spp (sample_n_frames(s, 17)), 3 x step_render; checks
              the image and that every kernel launched and no plain
              intersect version ran; inside the same window the exact
              kernel runs once on the camera rays, and K1's hits on them,
              taken before the window, must equal its own; a 32x32 render
              is held against the same render on the CPU
  5. breakdown  one 1-spp render of the main path under torch.profiler:
              device busy share of the wall, device ops per bounce
              iteration, each kernel's device time, and per bounce
              iteration the live share of the lanes and the closest-hit
              kernel's device ms; for the one-chunk box also the wrapper
              call on the lanes as they come and with the dead lanes
              partitioned first (sort, gather, kernel, two scatters)
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
              of the four kernels timed at cornell-sub6's shapes, wrapper
              call and launch alone (utils/kernel_timing.py), beside its
              bound (bytes or operations, whichever is larger); K2's
              and K4's in-kernel counts as scanned tests per lane beside
              the plain model's bracket; K1 (stream=False) and K2
              against the exact kernel on the same rays (best_t bits,
              best_i outside the tie band); K3 and K4 against the exact
              kernel's hits on all 524,288 shadow lanes; K1 and K2 alone
              on the same first-bounce rays of subdivide(cornell_like,
              4), 5 and 6, where ops/intersect_kernel.STREAM_MIN_T_PAD
              switches between them
  7. recip    K5: the approximate-reciprocal probe
              (utils/measure_recip.measure) at n = 2^20 on the card, its
              JSON line, max_rel within APPROX_RECIP_REL = 2^-8 and within
              RCP_APPROX_REL = 2^-22 (rcp.approx's documented 1 ulp); K5
              against its plain version at 2^20 + 1, 2^20 + 3 and on the
              offset view x[1:]; K5, torch.reciprocal and the plain version
              timed at 2^20 and 2^26 beside the bandwidth bound, and for
              K5 and torch.reciprocal the host microseconds per call and
              the device time alone (calls replayed from a CUDA graph)
  8. lidar    the LiDAR capture of the reference's demo-save: init(conf
              2) at 640x480, sample_points_n(s, 100), timed, with
              rays_traced taken from the same run; the points' window,
              miss encoding and return share, the nonce, K1/K3 launched
              and no plain version; K1 and K3 against their plain versions
              on every query of one 1-spp frame of the capture (307,200
              closest-hit rays and 614,400 shadow lanes per bounce, most
              of them aimed at the transmitter fan), K1 against the exact
              kernel on every closest query of it, and K3 against the
              exact kernel's hits on every shadow lane of it; K1 timed at
              the capture's shapes; a 32x32 8-spp capture
              against the CPU; 3 distance-mode steps; the flash (conf 1)
              against conf 0 on the box with its emission killed; the
              breakdown of one 1-spp LiDAR frame
  9. result   a JSON line of the kernels, then the last line
              {"ok": true, "device": {...}}

Tolerances (f32 sums in another order, FMA contraction in the kernel):
hit masks equal except on lanes whose u, v, 1-u-v, t or t-tmax lies
within 1e-5 of a validity boundary (computed in float64); best_t within
rtol 1e-5 where both hit; best_i equal except where the two smallest
candidate t's lie within 1e-5 of each other. K5 within RCP_APPROX_REL
(2^-22) of the plain version's 1/x, relative. K1 and K2 against the exact
kernel: best_t equal in every bit on every lane; best_i equal except
inside that tie band (equal everywhere while both walk 256-lane tiles).
K3 and K4 against the exact kernel's hits (isfinite(best_t) at the same
per-lane tmax): equal on every lane, no band, as all take a hit from the
same exact f32 arithmetic. The
card's LiDAR capture against the CPU's:
distances within rtol 1e-4 on >= 99% of pixels (a Russian-roulette or
frustum-edge flip moves a pixel), return shares within 0.02.

Bounds (bound_ms): the larger of the bytes a kernel must move (each
input read once, each output written once) over 3.35 TB/s and the f32
operations its inputs need over 67 TFLOP/s (the H100 SXM's published
rates at 700 W; the card's power limit is printed beside them). For
K1-K4 the operations are the (lane, triangle) tests the answer needs
(kernel_cases.needed_tests), 85 flops each: for a closest query every
chunk a ray enters up to its best t; for an any-hit query one chunk per
occluded lane and every chunk an unoccluded lane enters before tmax.
"""

import json
import os
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
EXACT = "closest_hit_exact"   # the yardstick, never on the path
REPLACES = {
    "closest_hit": "tracer_tpu/ops/pallas/intersect_kernel.py:429",
    EXACT: "tracer_tpu/ops/pallas/intersect_kernel.py:429",
    "closest_hit_streamed": "tracer_tpu/ops/pallas/intersect_kernel.py:589",
    "any_hit": "tracer_tpu/ops/pallas/intersect_kernel.py:497",
    "any_hit_streamed": "tracer_tpu/ops/pallas/intersect_kernel.py:704",
}
# Published H100 SXM rates (NVIDIA's data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
RECIP_SIZES = (1 << 20, 1 << 26)   # K5: the probe's n, and past the L2
# the reference's demo-save capture (frontends/save_demo.py defaults)
LIDAR_W, LIDAR_H, LIDAR_SPP = 640, 480, 100


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def tap(module, name, calls):
    """utils/kernel_timing.tap: within the block, each call of
    module.name also appends (args, kwargs, result) to calls."""
    from tracer_tpu_torch.utils import kernel_timing
    return kernel_timing.tap(module, name, calls)


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


def check_closest(ik, label, coeffs, phi, tmax, bounds, exact=None,
                  phase="kernels", fn=None, **kw):
    """fn: the wrapper held to the plain version, ik.closest_hit by
    default."""
    from tracer_tpu_torch.utils import kernel_cases as kc
    return compare_closest(
        phase, label, (fn or ik.closest_hit)(coeffs, phi, tmax, bounds, **kw),
        ik.closest_hit_ref(coeffs, phi, tmax, bounds),
        kc.boundary_lanes(coeffs, phi, tmax, bounds, rel=REL), exact)


def check_any(ik, label, coeffs, phi, tmax, bounds, exact=None,
              phase="kernels", **kw):
    from tracer_tpu_torch.utils import kernel_cases as kc
    edge, _ = kc.boundary_lanes(coeffs, phi, tmax, bounds, rel=REL)
    return compare_any(phase, label,
                       ik.any_hit(coeffs, phi, tmax, bounds, **kw),
                       ik.any_hit_ref(coeffs, phi, tmax, bounds), edge, exact)


def ms_per_call(fn, calls=TIME_CALLS, rounds=TIME_ROUNDS):
    """utils/kernel_timing.ms_per_call: median over `rounds` of the
    CUDA-event time of `calls` back-to-back calls divided by `calls`. The
    operands are built before; back to back, the wrapper's host work
    overlaps the previous launch, so the time is the kernel's (with the
    schedule the wrapper builds for it)."""
    from tracer_tpu_torch.utils import kernel_timing
    return kernel_timing.ms_per_call(fn, calls, rounds)


def shared_loads(path):
    """Shared-memory load instructions (LDS, by width) of each kernel in
    cuobjdump -sass of the library at `path`: {kernel: {opcode: count}}.
    Loops are counted once per copy the compiler emitted (the scan loop
    of K2 and K4 twice: the g = 1 and g > 1 walks each inline it). Also
    {kernel: (instructions, digest)}: how many instructions the kernel has
    and a SHA-1 of their text without the addresses, by which two builds
    show whether a kernel's code changed."""
    import hashlib
    import re
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", path], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    counts, code, cur = {}, {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = next((f"{k}_kernel"
                        for k in VARIANTS + (EXACT, "approx_reciprocal")
                        if f"{k}_kernel" in m.group(1)), m.group(1))
            if "ILb1E" in m.group(1):
                cur += " (stats on)"
            counts[cur], code[cur] = {}, []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if m and cur:
            code[cur].append(m.group(1).strip())
        m = re.search(r"\b(LDS(?:\.[A-Z0-9]+)*)\b", line)
        if m and cur and "@!PT" not in line:  # not a never-issued filler
            counts[cur][m.group(1)] = counts[cur].get(m.group(1), 0) + 1
    return counts, {k: (len(v), hashlib.sha1("\n".join(v).encode())
                        .hexdigest()[:12]) for k, v in code.items()}


def check_wide_loads(loads):
    """K1, K2, K3 and K4 (with and without stats) read shared memory only
    in their scan loop, one triangle per iteration: 10 LDS.128 in each
    copy of the loop, and no narrower load. The exact kernel (row-major
    stage, 64-bit loads) and K5 (no shared memory) are not held to it."""
    for k, c in loads.items():
        if k.startswith((f"{EXACT}_kernel", "approx_reciprocal")):
            continue
        wide = c.get("LDS.128", 0)
        log("build", f"{k}: {wide} LDS.128 = 10 per triangle in "
            f"{wide // 10} cop{'y' if wide == 10 else 'ies'} of the scan "
            f"loop, other shared loads {sum(c.values()) - wide}")
        if wide not in (10, 20) or sum(c.values()) != wide:
            raise AssertionError(f"{k} does not read a triangle with 10 "
                                 f"LDS.128: {c}")


def any_equals_exact(phase, label, co, phi, tmax, cb, stream):
    """K3 (stream False) or K4 (True) against the exact kernel's hits on
    every lane."""
    from tracer_tpu_torch.utils import kernel_timing
    cmp = kernel_timing.any_vs_exact(co, phi, tmax, cb, stream)
    log(phase, f"{'K4' if stream else 'K3'} against isfinite(exact best_t) "
        f"on {label}: {cmp['lanes']} lanes, {cmp['hits']} hits, "
        f"{cmp['differ']} lanes differ (no band)")
    if cmp["differ"]:
        raise AssertionError(f"the any-hit kernel and the exact kernel "
                             f"disagree on {label}")


def closest_equals_exact(phase, label, co, phi, tmax, cb, stream,
                         same_tiles=False, **kw):
    """K1 (stream False) or K2 (True) against the exact kernel on every
    lane: best_t bit for bit; best_i outside the tie band, and on every
    lane where both walk tiles of the same size (same_tiles). kw:
    max_sched."""
    from tracer_tpu_torch.utils import kernel_timing
    cmp = kernel_timing.closest_vs_exact(co, phi, tmax, cb, stream, **kw)
    log(phase, f"{'K2' if stream else 'K1'} against the exact kernel on "
        f"{label}: {cmp['lanes']} lanes, {cmp['hits']} hits, best_t differs "
        f"in bits on {cmp['best_t_bits_differ']} lanes, best_i on "
        f"{cmp['best_i_differ']} ({cmp['best_i_differ_outside_ties']} outside "
        f"the {REL:g} tie band; ties go by "
        f"{'index: the tiles are the same' if same_tiles else 't'})")
    if (cmp["best_t_bits_differ"] or cmp["best_i_differ_outside_ties"]
            or (same_tiles and cmp["best_i_differ"])):
        raise AssertionError(f"the closest-hit kernel and the exact kernel "
                             f"disagree on {label}")


def phase_kernels(ik, intersect, s, device, errs, card):
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
    any_equals_exact("kernels", "the Cornell shadow lanes", co, phi_sh, st,
                     cb, False)
    same = ik.BLOCK == ik.EXACT_BLOCK
    for label, phi in (("the Cornell camera rays", phi_cam),
                       ("the Cornell first-bounce rays", phi_bnc)):
        closest_equals_exact("kernels", label, co, phi, hi, cb, False, same)
    upd(EXACT, check_closest(ik, "exact kernel, cornell bounce", co, phi_bnc,
                             hi, cb, fn=ik.closest_hit_exact))
    # K1 under a mixed per-lane tmax, as the path hands it dead lanes:
    # live, 0 and NaN lanes scattered through every warp
    lane = torch.arange(phi_bnc.shape[1], device=device)
    mixed = torch.where(lane % 5 == 1, 0.0, torch.where(
        lane % 7 == 3, float("nan"),
        torch.as_tensor(hi, dtype=torch.float32, device=device)))
    upd("closest_hit", check_closest(ik, "cornell bounce, mixed per-lane tmax",
                                     co, phi_bnc, mixed, cb))
    closest_equals_exact("kernels", "the same under the mixed tmax", co,
                         phi_bnc, mixed, cb, False, same)
    bt, bi = ik.closest_hit(co, phi_bnc, mixed, cb)
    off = ~(mixed > 0)
    log("kernels", f"K1 mixed tmax: {int(off.sum())} lanes with tmax 0 or "
        f"NaN, of them not (+inf, 0): "
        f"{int((torch.isfinite(bt[off]) | (bi[off] != 0)).sum())}")
    if bool(torch.isfinite(bt[off]).any()) or bool((bi[off] != 0).any()):
        raise AssertionError("a lane with tmax 0 or NaN must give (+inf, 0)")
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
                upd(ik.variant_name("closest", stream),
                    check_closest(ik, tag, rd.coeffs, phi_r, tm,
                                  rd.chunk_bounds, exact=nan_lanes, **kw))
                if not stream:
                    upd(EXACT, check_closest(
                        ik, f"exact kernel, {tag}", rd.coeffs, phi_r, tm,
                        rd.chunk_bounds, exact=nan_lanes,
                        fn=ik.closest_hit_exact, max_sched=max_sched))
                closest_equals_exact("kernels", tag, rd.coeffs, phi_r, tm,
                                     rd.chunk_bounds, stream,
                                     max_sched=max_sched)
                upd(ik.variant_name("any", stream),
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

    # timing and bounds at the Cornell shapes, where the main path
    # launches K1 and K3: closest on first-bounce rays, any on 2N
    from tracer_tpu_torch.utils import kernel_timing
    cornell = {}
    for k, query, phi, tm in (("closest_hit", "closest", phi_bnc, hi),
                              (EXACT, "closest", phi_bnc, hi),
                              ("any_hit", "any", phi_sh, st)):
        t = kernel_timing.kernel_times("exact" if k == EXACT else query, co,
                                       phi, tm, cb, False)
        ref = ik.closest_hit_ref if query == "closest" else ik.any_hit_ref
        t["plain_ms"] = ms_per_call(lambda: ref(co, phi, tm, cb))
        t["bound_ms"], t["bound_by"] = query_bound(
            ik, query, f"{k} at the Cornell shapes", co, cb, phi, tm, card,
            phase="kernels")
        log("kernels", f"time {k} at the Cornell shapes: wrapper "
            f"{t['ms']:.4f} ms, launch alone {t['alone_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}) (median of {TIME_ROUNDS} rounds of "
            f"{TIME_CALLS} back-to-back calls, {phi.shape[1]} lanes, on "
            f"{card})")
        cornell[k] = t
    k1, ex, k3 = cornell["closest_hit"], cornell[EXACT], cornell["any_hit"]
    log("kernels", f"K1 wrapper / alone at the Cornell shapes {k1['ms']:.4f} "
        f"/ {k1['alone_ms']:.4f} ms = "
        f"{100 * k1['bound_ms'] / k1['alone_ms']:.1f}% of its bound alone, "
        f"beside {ex['ms']:.4f} / {ex['alone_ms']:.4f} ms of the exact "
        f"kernel, the block-granular, row-major K1 before it, in this run; "
        f"K3 {k3['ms']:.4f} / {k3['alone_ms']:.4f} ms = "
        f"{100 * k3['bound_ms'] / k3['alone_ms']:.1f}% of its bound (on "
        f"{card})")
    if not k1["alone_ms"] < ex["alone_ms"]:
        raise AssertionError("K1 is not faster than the exact kernel at the "
                             "Cornell shapes")
    return cornell


# ---------------------------------------------------------------------------
# main path

def load_cornell():
    """The capture frontend's scene: CornellBox-Original.obj from
    $TRACER_ASSETS when it is there, else the procedural Cornell box (as
    bench.py chooses). Returns ((tris, tri_mats, mats), name)."""
    from tracer_tpu_torch.frontends.save_demo import load_scene
    return load_scene(None)


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


def render_16spp(T, integrator, ik, s, phase, card, before=None):
    """Warm up, call before() if given, set the counts to 0, time
    render_frames at 16 spp, and check that sample_n_frames(s, 17) gives
    the same image. Returns (image, launches, plain_calls) of that run."""
    import torch
    w, h = s.sub_dims
    T.sample_n_frames(s, 1)   # warm-up: first launches, allocator
    if before is not None:
        before()
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
    from tracer_tpu_torch.ops import intersect, shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    s = T.init(0, SIZE, SIZE, 0, tris, tm, mats, cam_origin=CAM_ORIGIN,
               device=device)
    dense = s.scene.accel
    phi_cam = intersect.ray_features_t(*kc.render_rays(s)[0])
    k1 = []   # K1 on the camera rays, taken before the counts are set to 0
    img, _, _ = render_16spp(
        T, integrator, ik, s, "main", card,
        before=lambda: k1.extend(ik.closest_hit(
            dense.coeffs, phi_cam, shapes.F32_HIGHEST, dense.chunk_bounds)))
    s2 = s
    for _ in range(3):
        s2, argb = T.step_render(s2)
        if tuple(argb.shape) != (SIZE, SIZE) or argb.dtype != torch.uint32:
            raise AssertionError(f"step_render gave {argb.dtype} "
                                 f"{tuple(argb.shape)}")
    # the yardstick's one launch inside the window: the path never calls
    # it, the smoke run holds the path's kernel to it
    ex_t, _ = ik.closest_hit_exact(dense.coeffs, phi_cam, shapes.F32_HIGHEST,
                                   dense.chunk_bounds)
    torch.cuda.synchronize()
    launches = dict(ik.launches)
    plain = dict(ik.plain_calls)
    log("main", f"launches={launches} plain_calls={plain}")
    differ = int((ex_t.view(torch.int32) != k1[0].view(torch.int32)).sum())
    log("main", f"the exact kernel inside the window, on the "
        f"{phi_cam.shape[1]} camera rays: {int(torch.isfinite(ex_t).sum())} "
        f"hits, best_t differs in bits from K1's on {differ} lanes")
    if differ:
        raise AssertionError("K1 and the exact kernel disagree on the camera "
                             "rays")
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


def phase_breakdown(integrator, ik, s, card, names, phase="breakdown",
                    one_chunk=False):
    """Where the time of one 1-spp render goes, for the kernels `names`
    (closest first) that the render launches once per bounce iteration;
    one_chunk: also time the dead-lane partition per bounce.
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
    spans = {}
    for k in names:
        ks = [e.time_range.elapsed_us() for e in sorted(
            (e for e in dev if f"{k}_kernel" in e.name),
            key=lambda e: e.time_range.start)]
        if len(ks) != iters:
            raise AssertionError(f"{len(ks)} {k}_kernel spans in the trace, "
                                 f"{iters} bounce iterations")
        log(phase, f"{k}_kernel: {len(ks)} launches, "
            f"{sum(ks) / 1e3:.3f} ms on the device "
            f"({sum(ks) / len(ks) / 1e3:.4f} ms each), "
            f"{100 * sum(ks) / 1e6 / busy:.1f}% of device busy time")
        spans[k] = ks
    del prof, dev
    # per bounce iteration: the live share of the lanes (the same frame
    # again, its closest queries tapped at the wrapper) and the closest
    # kernel's span in the trace above
    from tracer_tpu_torch.utils import kernel_timing
    queries = kernel_timing.bounce_queries(integrator, s)
    if len(queries) != iters:
        raise AssertionError(f"{len(queries)} closest queries in the frame, "
                             f"{iters} bounce iterations")
    live = [float((q[2] > 0).float().mean()) for q in queries]
    log(phase, f"per bounce iteration, live share of {queries[0][1].shape[1]} "
        f"lanes / {names[0]}_kernel ms in the profiled frame: "
        + ", ".join(f"{i}: {100 * p:.2f}% / {t / 1e3:.4f}"
                    for i, (p, t) in enumerate(zip(live, spans[names[0]])))
        + f"; lane-iterations live {100 * sum(live) / len(live):.2f}%")
    if one_chunk:
        rows = kernel_timing.bounce_times(queries, partition=True)
        log(phase, "per bounce iteration on the one-chunk box, ms: kernel "
            "alone / wrapper on the lanes as they come / wrapper with the "
            "dead lanes partitioned first (sort, gather, kernel, two "
            "scatters): "
            + ", ".join(f"{i}: {r['kernel_ms']:.4f} / {r['unsorted_ms']:.4f} "
                        f"/ {r['partition_ms']:.4f}"
                        for i, r in enumerate(rows))
            + f"; sums {sum(r['kernel_ms'] for r in rows):.4f} / "
            f"{sum(r['unsorted_ms'] for r in rows):.4f} / "
            f"{sum(r['partition_ms'] for r in rows):.4f} ms over "
            f"{len(rows)} iterations (median of {TIME_ROUNDS} rounds of "
            f"{TIME_CALLS} back-to-back calls each, on {card})")


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
            name = ik.variant_name(query,
                                   ik.streamed_variant(co.shape[1], stream))
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


def phase_big_kernels(ik, intersect, device, errs):
    """(1) all four kernels on subdivide(cornell_like, 5) and on
    cornell-sub6 at the main path's 512x512 shapes. Returns the states."""
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    from tracer_tpu_torch.utils import kernel_timing
    states = {}
    for levels in (RESIDENT_LEVELS, SLICE_LEVELS):
        s = kernel_timing.sub_state(levels, SIZE, device)
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
    at the blocks of K2 and K4, without and with the permutation the main
    path applies."""
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    dense = s.scene.accel
    cb = dense.chunk_bounds
    _, (bo, bd), (so, sd, st) = kc.render_rays(s)
    for label, phi, tmax, dead_first, tile in (
            ("first-bounce closest", intersect.ray_features_t(bo, bd),
             shapes.F32_HIGHEST, False, ik.BLOCKS["closest_hit_streamed"]),
            ("shadow 2N", intersect.ray_features_t(so, sd), st, True,
             ik.BLOCKS["any_hit_streamed"])):
        for perm in ("off", "odmorton"):
            p, t = phi, tmax
            if perm != "off":
                idx = intersect.lane_order(phi, tmax, cb, perm,
                                           dead_first=dead_first)
                p = phi[:, idx]
                t = tmax[idx] if dead_first else tmax
            g, sb, _, count = ik.walk_schedule(p, t, cb, ik.MAX_SCHED, tile)
            c = count.float()
            log("bigscene", f"schedule {label} perm={perm}: {c.shape[0]} "
                f"blocks of {tile} lanes, entries per block mean "
                f"{float(c.mean()):.2f} max {int(c.max())} of {sb.shape[0]} "
                f"superchunks (g = {g}), blocks with none "
                f"{int((c == 0).sum())}")


def bound(bytes_moved, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def query_bound(ik, query, label, co, cb, phi, tmax, card, phase="bigscene"):
    """The bound of one closest- or any-hit call on these inputs: coeffs,
    chunk bounds, features and tmax read once, the outputs (8 B or 1 B a
    lane) written once; operations: the tests the kernel's own answer
    needs (kernel_cases.needed_tests), 85 flops each."""
    import torch
    from tracer_tpu_torch.utils import kernel_cases as kc
    n = phi.shape[1]
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    chunk_t = co.shape[1] // cb.shape[0]
    if query == "closest":
        bt, _ = ik.closest_hit(co, phi, tmax, cb)
        near = torch.where(torch.isfinite(bt), bt, tmax.expand(n))
        tests, out_bytes = kc.needed_tests(phi, near, cb, chunk_t), 8
        what = "chunks entered up to the best t"
    else:
        occ = ik.any_hit(co, phi, tmax, cb)
        tests = kc.needed_tests(phi, tmax, cb, chunk_t, occluded=occ)
        out_bytes = 1
        what = (f"one chunk for each of {int(occ.sum())} occluded lanes, "
                f"chunks entered before tmax for the rest")
    flops = tests * kc.FLOPS_PER_TEST
    moved = 4 * (co.numel() + cb.numel() + phi.numel() + tmax.numel()) \
        + out_bytes * n
    ms, by = bound(moved, flops)
    log(phase, f"bound {label}: {moved / 1e6:.2f} MB moved "
        f"({1e3 * moved / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s), {tests} "
        f"needed tests ({what}) = {tests / n:.1f} per lane = "
        f"{flops / 1e9:.2f} GFLOP ({1e3 * flops / F32_FLOPS_PER_S:.4f} ms at "
        f"67 TFLOP/s f32): {ms:.4f} ms, bound by {by} (published rates at "
        f"700 W; card {card})")
    return ms, by


def phase_big_timing(ik, s, card):
    """(5) each of the four kernels on cornell-sub6's first-bounce rays
    (closest) and 2N shadow lanes (any), on the lanes as the main path
    orders them (perm="auto": odmorton), wrapper call and launch alone,
    beside the plain version and the bound on the same inputs; K2's and
    K4's in-kernel counts against the plain model of their cull, K1 and
    K2 against the exact kernel on the same rays, K3 and K4 against the
    exact kernel's hits on the shadow lanes, and K1 beside K2 at three
    scene sizes."""
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_timing
    dense = s.scene.accel
    co, cb = dense.coeffs, dense.chunk_bounds
    hi = shapes.F32_HIGHEST
    phi_b, phi_s, st = kernel_timing.timed_rays(s)
    plain = {
        "closest": ms_per_call(lambda: ik.closest_hit_ref(co, phi_b, hi, cb),
                               calls=1, rounds=3),
        "any": ms_per_call(lambda: ik.any_hit_ref(co, phi_s, st, cb),
                           calls=1, rounds=3)}
    bounds = {
        "closest": query_bound(ik, "closest", "closest (first-bounce rays)",
                               co, cb, phi_b, hi, card),
        "any": query_bound(ik, "any", "any hit (2N shadow lanes)", co, cb,
                           phi_s, st, card)}
    shapes_of = {
        "closest": f"{phi_b.shape[1]} first-bounce rays of cornell-sub6, "
                   f"odmorton order",
        "any": f"{phi_s.shape[1]} shadow lanes (2N) of cornell-sub6, "
               f"odmorton order, dead lanes first"}
    times = {}
    for stream in (False, True):
        for query, phi, tm in (("closest", phi_b, hi), ("any", phi_s, st)):
            times[ik.variant_name(query, stream)] = {
                **kernel_timing.kernel_times(query, co, phi, tm, cb, stream),
                "plain_ms": plain[query], "bound_ms": bounds[query][0],
                "bound_by": bounds[query][1], "library_ms": None,
                "timed_at": shapes_of[query]}
    ex_launch, _ = ik.prepared_launch("exact", co, phi_b, hi, cb)
    ex_ms = ms_per_call(lambda: ik.closest_hit_exact(co, phi_b, hi, cb),
                        calls=5, rounds=3)
    times[EXACT] = {
        "ms": ex_ms, "alone_ms": ms_per_call(ex_launch, calls=5, rounds=3),
        "plain_ms": plain["closest"], "bound_ms": bounds["closest"][0],
        "bound_by": bounds["closest"][1], "library_ms": None,
        "timed_at": shapes_of["closest"]}
    for k, t in times.items():
        runs = ("3 rounds of 5" if k == EXACT
                else f"{TIME_ROUNDS} rounds of {TIME_CALLS}")
        log("bigscene", f"time {k}: wrapper {t['ms']:.4f} ms (schedule "
            f"built in the call), launch alone {t['alone_ms']:.4f} ms "
            f"(median of {runs} back-to-back "
            f"calls), plain {t['plain_ms']:.4f} ms (median of 3 single "
            f"calls), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"{t['timed_at']}, on {card}")
    k2, k4 = times["closest_hit_streamed"], times["any_hit_streamed"]
    k1, k3, ex = times["closest_hit"], times["any_hit"], times[EXACT]
    log("bigscene", f"K1 wrapper / alone at cornell-sub6's shapes "
        f"(stream=False) {k1['ms']:.4f} / {k1['alone_ms']:.4f} ms = "
        f"{100 * k1['bound_ms'] / k1['alone_ms']:.1f}% of its bound alone, "
        f"beside {ex['ms']:.4f} / {ex['alone_ms']:.4f} ms of the exact "
        f"kernel, the block-granular, row-major K1 before it, in this run "
        f"(on {card})")
    log("bigscene", f"K2 wrapper / alone {k2['ms']:.4f} / "
        f"{k2['alone_ms']:.4f} ms, beside 21.2074 / 18.2619 ms with its tiles "
        f"in index order and the wrapper time 61.3789 ms of the "
        f"block-granular K2 before that; K4 {k4['ms']:.4f} / "
        f"{k4['alone_ms']:.4f} ms and K3 {k3['ms']:.4f} / "
        f"{k3['alone_ms']:.4f} ms, beside 21.8144 / 17.5741 ms and 20.8726 / "
        f"16.6858 ms of the block-granular, row-major K4 and K3 before them "
        f"(NVIDIA H100 80GB HBM3, 700.00 W)")

    sc = kernel_timing.k2_scans(co, phi_b, hi, cb)
    lo, up = sc["warp_model_per_lane"]
    blo, bup = sc["block256_model_per_lane"]
    log("bigscene", f"K2 counts ({ik.STREAMED_CLOSEST_BLOCK}-lane blocks, "
        f"{sc['lanes']} first-bounce rays): {sc['warp_scans']} warp scans "
        f"= {sc['scanned_per_lane']:.1f} scanned tests per lane; plain model "
        f"of the warp cull {lo:.1f} (at the final best t) .. {up:.1f} (at "
        f"tmax); block-granular cull at 256 lanes {blo:.1f} .. {bup:.1f}; "
        f"needed {sc['needed_per_lane']:.1f}; the block-granular K2's reach "
        f"53.40 of 59 "
        f"superchunks = {53.40 * 6 * 256:.0f} per lane; chunks copied "
        f"{sc['copies']} = {sc['copies_per_block']:.2f} per block, schedule "
        f"entries {sc['entries_per_block'][0]:.2f} per block (at most "
        f"{sc['entries_per_block'][1]}); the model's copies per block "
        f"{sc['model_copies_per_block'][0]:.2f} in the mean, at most "
        f"{sc['model_copies_per_block'][1]}")
    if not (lo <= sc["scanned_per_lane"] <= up and up <= bup
            and sc["scanned_per_lane"] < 53.40 * 6 * 256):
        raise AssertionError("K2's scans fall outside the plain model's "
                             "bracket")
    sc = kernel_timing.k4_scans(co, phi_s, st, cb)
    lo, up = sc["warp_model_per_lane"]
    blo, bup = sc["block256_model_per_lane"]
    log("bigscene", f"K4 counts ({ik.STREAMED_ANY_BLOCK}-lane blocks, "
        f"{sc['lanes']} shadow lanes, {sc['dead']} dead, {sc['occluded']} "
        f"occluded): {sc['warp_scans']} warp scans = "
        f"{sc['scanned_per_lane']:.1f} scanned tests per lane; plain model "
        f"of the warp cull {lo:.1f} (the lanes that never stop) .. {up:.1f} "
        f"(every lane at its tmax); block-granular cull at 256 lanes "
        f"{blo:.1f} .. {bup:.1f}; needed {sc['needed_per_lane']:.1f}; chunks "
        f"copied {sc['copies']} = {sc['copies_per_block']:.2f} per block, "
        f"schedule entries {sc['entries_per_block'][0]:.2f} per block (at "
        f"most {sc['entries_per_block'][1]}); the model's copies per block "
        f"{sc['model_copies_per_block'][0]:.2f} in the mean, at most "
        f"{sc['model_copies_per_block'][1]}")
    if not (lo <= sc["scanned_per_lane"] <= up and up <= bup):
        raise AssertionError("K4's scans fall outside the plain model's "
                             "bracket")
    order = kernel_timing.k2_block_order(co, phi_b, hi, cb)
    log("bigscene", f"K2 alone with its tiles longest schedule first, as it "
        f"launches them, {order['heavy_first_ms']:.4f} ms; in index order "
        f"{order['index_order_ms']:.4f} ms (on {card})")
    closest_equals_exact("bigscene", "cornell-sub6's first-bounce rays, "
                         "stream=False", co, phi_b, hi, cb, False,
                         ik.BLOCK == ik.EXACT_BLOCK)
    closest_equals_exact("bigscene", "cornell-sub6's first-bounce rays", co,
                         phi_b, hi, cb, True)
    for stream in (False, True):
        any_equals_exact("bigscene", "cornell-sub6's shadow lanes", co, phi_s,
                      st, cb, stream)
    pairs = kernel_timing.stream_pairs(SIZE, phi_b.device,
                                       states={SLICE_LEVELS: s})
    log("bigscene", "K1 / K2 alone on the same first-bounce rays and K3 / "
        "K4 on the same 2N shadow lanes (odmorton order): " + "; ".join(
            f"subdivide(cornell_like, {lv}), T_pad {r['t_pad']}: "
            f"{r['k1_alone_ms']:.4f} / {r['k2_alone_ms']:.4f} and "
            f"{r['k3_alone_ms']:.4f} / {r['k4_alone_ms']:.4f} ms"
            for lv, r in pairs.items())
        + f"; stream=None streams above T_pad {ik.STREAM_MIN_T_PAD} (median "
        f"of 5 rounds of 10 back-to-back launches, on {card})")
    return times


def phase_bigscene(T, integrator, ik, intersect, card, device, errs,
                   cornell_mean):
    import torch
    states = phase_big_kernels(ik, intersect, device, errs)
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
    return launches, phase_big_timing(ik, s, card)


# ---------------------------------------------------------------------------
# K5, the approximate reciprocal

def phase_recip(device, card):
    """K5's entry point at the probe's n = 2^20 on the card, with the
    counts set to 0 before it; then K5 against its plain version on its
    ragged cases (2^20 + 1, 2^20 + 3, x[1:]), and K5, torch.reciprocal (the
    library yardstick) and the plain version timed at 2^20 (8 MB, inside
    the 50 MB L2) and 2^26 (512 MB, past it), with the host microseconds
    per call of K5 and of torch.reciprocal."""
    import torch
    from tracer_tpu_torch.ops import recip
    from tracer_tpu_torch.utils import kernel_timing, measure_recip
    recip.reset_counts()
    res = measure_recip.measure(RECIP_SIZES[0], device)
    launches = recip.launches[recip.NAME]
    print(json.dumps(res), flush=True)
    log("recip", f"measure n={res['n']}: max_rel {res['max_rel']:.4e} = "
        f"2^{res['log2_max']:.3f}, p99.9 {res['p999_rel']:.4e}, limits "
        f"APPROX_RECIP_REL = 2^-8 (the JAX package's slack) and "
        f"RCP_APPROX_REL = 2^-22 (rcp.approx's 1 ulp), kernel="
        f"{res['kernel']}, launches={launches}, on {card}")
    if not res["kernel"] or launches != 1:
        raise AssertionError("measure_recip did not launch K5 once")
    if not res["max_rel"] <= min(recip.APPROX_RECIP_REL, recip.RCP_APPROX_REL):
        raise AssertionError("K5's error exceeds RCP_APPROX_REL")
    ragged = torch.as_tensor(measure_recip.inputs(RECIP_SIZES[0] + 3),
                             device=device)
    for label, x in (("2^20 + 1", ragged[:-2]), ("2^20 + 3", ragged),
                     ("x[1:] of 2^20 + 3", ragged[1:])):
        y, ref = recip.approx_reciprocal(x), recip.approx_reciprocal_ref(x)
        torch.cuda.synchronize()
        rel = float(((y.double() - ref.double()) / ref.double()).abs().max())
        log("recip", f"K5 at n = {label} (data_ptr % 16 = "
            f"{x.data_ptr() % 16}): max rel {rel:.3e} against its plain "
            f"version")
        if not rel <= recip.RCP_APPROX_REL:
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"{label}")
    del ragged
    x20 = torch.as_tensor(measure_recip.inputs(RECIP_SIZES[0]), device=device)
    out = {"launches": launches, "max_abs_err": 0.0}
    for n in RECIP_SIZES:
        x = x20.repeat(n // x20.numel())
        y, ref = recip.approx_reciprocal(x), recip.approx_reciprocal_ref(x)
        torch.cuda.synchronize()
        rel = float(((y.double() - ref.double()) / ref.double()).abs().max())
        abs_err = float((y - ref).abs().max())
        if not rel <= recip.RCP_APPROX_REL:
            raise AssertionError(f"K5 disagrees with its plain version at {n}")
        t = {"ms": ms_per_call(lambda: recip.approx_reciprocal(x)),
             "library_ms": ms_per_call(lambda: torch.reciprocal(x)),
             "plain_ms": ms_per_call(lambda: recip.approx_reciprocal_ref(x))}
        t["bound_ms"], t["bound_by"] = bound(8 * n, 0)
        host = {"K5": kernel_timing.host_us_per_call(
                    lambda: recip.approx_reciprocal(x), 500),
                "torch.reciprocal": kernel_timing.host_us_per_call(
                    lambda: torch.reciprocal(x), 500)}
        t["graph_ms"] = kernel_timing.graph_ms_per_call(
            lambda: recip.approx_reciprocal(x))
        t["library_graph_ms"] = kernel_timing.graph_ms_per_call(
            lambda: torch.reciprocal(x))
        log("recip", f"n=2^{n.bit_length() - 1}: K5 {t['ms']:.4f} ms, "
            f"torch.reciprocal {t['library_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (8 B x n "
            f"at 3.35 TB/s), roofline share "
            f"{100 * t['bound_ms'] / t['ms']:.1f}%; vs plain: max rel "
            f"{rel:.3e}, max abs {abs_err:.3e} (median of {TIME_ROUNDS} "
            f"rounds of {TIME_CALLS} back-to-back calls, on {card}); host "
            f"per call: K5 {host['K5']:.2f} us, torch.reciprocal "
            f"{host['torch.reciprocal']:.2f} us (host clock over 500 queued "
            f"calls, before one synchronise); device alone (20 calls in one "
            f"CUDA graph): K5 {t['graph_ms']:.4f} ms, torch.reciprocal "
            f"{t['library_graph_ms']:.4f} ms")
        if n == RECIP_SIZES[0]:
            out.update(t, max_abs_err=abs_err, host_us=host["K5"],
                       library_host_us=host["torch.reciprocal"],
                       timed_at=f"n = 2^20 f32, the probe's inputs")
    return out


# ---------------------------------------------------------------------------
# the LiDAR capture

def fan_lanes(phi, tmax, cam, origin):
    """Shadow lanes aimed at the transmitter fan: live lanes whose light
    point (the ray's end plus the occlusion slack) lies on the fan's disk
    around the camera origin."""
    import torch
    from tracer_tpu_torch.engine import direct
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device)
    end = phi[3:6] + phi[0:3] * (tmax + direct.OCCLUSION_EPS)
    r = torch.linalg.vector_norm(
        end - torch.tensor(origin, device=phi.device)[:, None], dim=0)
    return (tmax > 0) & (r <= float(cam.conf.trans_radius) + 0.02)


def check_capture_queries(ik, integrator, s, card, errs):
    """K1 and K3 against their plain versions on every closest- and
    any-hit query of one 1-spp frame of the capture, as the path hands
    them to the kernels (tapped at the wrapper), K1 against the exact
    kernel on every closest query and K3 against the exact kernel's hits
    on every shadow lane of the frame; then K1 timed on the frame's first
    closest query, every lane live. Returns those times."""
    closest, anyq = [], []
    with tap(ik, "closest_hit", closest), tap(ik, "any_hit", anyq):
        integrator.render_frames(s.seed, s.nonce, s.scene, s.cam,
                                 s.ambience, LIDAR_W, LIDAR_H,
                                 s.transmitter_kind, 1, s.render_mode,
                                 with_points=True)
    if not closest or len(closest) != len(anyq):
        raise AssertionError("the capture frame made no kernel queries")
    fan = []
    for i, ((co, phi, tm, cb), kw, _) in enumerate(closest):
        errs["closest_hit"] = max(errs["closest_hit"], check_closest(
            ik, f"capture bounce {i}", co, phi, tm, cb, phase="lidar", **kw))
        closest_equals_exact("lidar", f"capture bounce {i} (live lanes "
                             f"{int((tm > 0).sum())})", co, phi, tm, cb,
                             False, ik.BLOCK == ik.EXACT_BLOCK)
    for i, ((co, phi, tm, cb), kw, hit) in enumerate(anyq):
        f = fan_lanes(phi, tm, s.cam, CAM_ORIGIN)
        fan.append((int(f.sum()), int((hit & f).sum())))
        errs["any_hit"] = max(errs["any_hit"], check_any(
            ik, f"capture bounce {i} (fan lanes {fan[-1][0]}, of them "
            f"occluded {fan[-1][1]})", co, phi, tm, cb, phase="lidar", **kw))
        any_equals_exact("lidar", f"capture bounce {i}", co, phi, tm, cb, False)
    log("lidar", f"K1/K3 held to the plain versions on {len(closest)} "
        f"bounces of a 1-spp {LIDAR_W}x{LIDAR_H} frame: "
        f"{closest[0][0][1].shape[1]} closest rays and "
        f"{anyq[0][0][1].shape[1]} shadow lanes per bounce, "
        f"{sum(k for k, _ in fan)} shadow lanes aimed at the transmitter "
        f"fan, on {card}")
    if fan[0][0] == 0:
        raise AssertionError("no shadow lane of the capture aims at the fan")
    from tracer_tpu_torch.utils import kernel_timing
    (co, phi, tm, cb), _, _ = closest[0]
    t = kernel_timing.kernel_times("closest", co, phi, tm, cb, False)
    t["bound_ms"], t["bound_by"] = query_bound(
        ik, "closest", "closest_hit at the capture's shapes", co, cb, phi,
        tm, card, phase="lidar")
    log("lidar", f"time closest_hit at the capture's shapes: wrapper "
        f"{t['ms']:.4f} ms, launch alone {t['alone_ms']:.4f} ms = "
        f"{100 * t['bound_ms'] / t['alone_ms']:.1f}% of its bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}) (median of {TIME_ROUNDS} "
        f"rounds of {TIME_CALLS} back-to-back calls, {phi.shape[1]} primary "
        f"rays, every lane live, on {card})")
    return t


def phase_lidar(T, integrator, ik, scene_arrays, card, device, errs):
    """The reference's demo-save capture through the entry points, and the
    checks of the LiDAR and flash sensors. Returns the capture's
    launches and K1's times at the capture's shapes."""
    import torch
    from tracer_tpu_torch.engine import keys
    tris, tm, mats = scene_arrays
    s = T.init(0, LIDAR_H, LIDAR_W, 2, tris, tm, mats, cam_origin=CAM_ORIGIN,
               device=device)
    T.sample_points_n(s, 1)   # warm-up
    torch.cuda.synchronize()
    frames = []
    ik.reset_counts()
    t0 = time.perf_counter()
    with tap(integrator, "render_frames", frames):
        s2, pts = T.sample_points_n(s, LIDAR_SPP)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain = dict(ik.launches), dict(ik.plain_calls)
    if len(frames) != 1:
        raise AssertionError("sample_points_n did not render once")
    rays = frames[0][2]["rays_traced"]
    del frames
    has = pts[..., 3] > 0
    share = float(has.float().mean())
    log("lidar", f"sample_points_n {LIDAR_W}x{LIDAR_H} x {LIDAR_SPP} spp "
        f"(config 2, {s.transmitter_kind} transmitter): {secs:.3f} s, "
        f"rays_traced={rays}, {rays / secs / 1e6:.2f} Mrays/s; returns "
        f"{100 * share:.2f}% of pixels; launches={launches} "
        f"plain_calls={plain}; on {card}")
    if tuple(pts.shape) != (LIDAR_H, LIDAR_W, 4):
        raise AssertionError(f"points of shape {tuple(pts.shape)}")
    miss = torch.tensor([-1.0, -1.0, -1.0, 0.0], device=device)
    if not bool((pts[~has] == miss).all()):
        raise AssertionError("a pixel without a return is not (-1,-1,-1,0)")
    r = torch.linalg.vector_norm(
        pts[has][:, :3] - torch.tensor(CAM_ORIGIN, device=device), dim=-1)
    log("lidar", f"return distances from the camera: {float(r.min()):.4f}"
        f" .. {float(r.max()):.4f}")
    if not bool(((r > 0.4) & (r < 10.1)).all()) or share < 0.3:
        raise AssertionError("returns outside the window, or under 30%")
    if s2.nonce != s.nonce + LIDAR_SPP:
        raise AssertionError("the nonce did not advance by spp")
    if (launches["closest_hit"] <= 0 or launches["any_hit"] <= 0
            or max(plain.values()) != 0):
        raise AssertionError("the capture did not run through K1 and K3")
    del pts
    capture_k1 = check_capture_queries(ik, integrator, s, card, errs)
    torch.cuda.empty_cache()

    # a 32x32 8-spp capture on the card against the same on the CPU
    dists = []
    for dev in (device, "cpu"):
        sm = T.init(0, 32, 32, 2, tris, tm, mats, cam_origin=CAM_ORIGIN,
                    device=dev)
        o = integrator.render_frames(sm.seed, sm.nonce, sm.scene, sm.cam,
                                     sm.ambience, 32, 32, sm.transmitter_kind,
                                     8, sm.render_mode, with_points=True)
        dists.append(o["points"][1].cpu())
    dc, dr = dists
    agree = (torch.isclose(dc, dr, rtol=1e-4)
             | (torch.isinf(dc) & torch.isinf(dr)))
    frac = float(agree.float().mean())
    sc, sr = (float(torch.isfinite(x).float().mean()) for x in dists)
    log("lidar", f"32x32 8spp card vs cpu: distances within rtol 1e-4 on "
        f"{frac:.4f} of pixels, return shares {sc:.4f} / {sr:.4f}")
    if frac < 0.99 or abs(sc - sr) > 0.02:
        raise AssertionError("the card's capture disagrees with the CPU's")

    # 3 distance-mode steps, the merge on
    sd = T.key(keys.KEYDOWN, keys.SDLK_m, s)
    for _ in range(3):
        sd = T.step(sd)
        if not bool(torch.isfinite(sd.img).all()) or float(
                sd.img.min()) < 0 or float(sd.img.max()) > 1.0 + 1e-6:
            raise AssertionError("a distance frame is not finite in [0, 1]")
    log("lidar", f"3 distance-mode steps: n_frames={sd.n_frames}, pixels "
        f"with a return {float((sd.img.sum(-1) > 0).float().mean()):.4f}")
    del sd

    # the flash: config 1 against config 0 on the box with no emission
    dark_mats = mats.copy()
    dark_mats[:, 16:28] = [-1.0, 0.0] * 6
    means = {}
    for conf in (0, 1):
        sf = T.init(0, 128, 128, conf, tris, tm, dark_mats,
                    cam_origin=CAM_ORIGIN, device=device)
        means[conf] = float(T.sample_n_frames(sf, 17).mean())
    log("lidar", f"128x128 16spp, emission killed: config 0 mean "
        f"{means[0]:.3e}, config 1 (flash) mean {means[1]:.3e}")
    if not (means[0] < 1e-4 and means[1] > 10 * max(means[0], 1e-6)):
        raise AssertionError("the flash does not light the dark box")

    phase_breakdown(integrator, ik, s, card, ("closest_hit", "any_hit"),
                    phase="lidar")
    return launches, capture_k1


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
        from tracer_tpu_torch.ops import cuda_lib, intersect
        from tracer_tpu_torch.ops import intersect_kernel as ik
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    from tracer_tpu_torch.utils import kernel_timing
    card = kernel_timing.card_line()
    log("device", f"torch.cuda: {torch.cuda.get_device_name(0)}; "
        f"count={torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    print(card, flush=True)

    ik.build()
    info = cuda_lib.build_info()
    log("build", f"nvcc build of {' and '.join(info['sources'])} into one "
        f"library: {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build", line.strip())
    loads, code = shared_loads(info["path"])
    for k, c in loads.items():
        log("build", f"cuobjdump -sass {k}: {code[k][0]} instructions "
            f"(digest {code[k][1]}), shared-memory loads {c}")
    check_wide_loads(loads)
    lib = ik.build()
    log("build", f"K1: {ik.BLOCK} lanes per block, at least "
        f"{lib.closest_min_blocks()} blocks per SM; exact kernel "
        f"{ik.EXACT_BLOCK} lanes, K2 {ik.STREAMED_CLOSEST_BLOCK}, K3 "
        f"{ik.ANY_BLOCK}, K4 {ik.STREAMED_ANY_BLOCK}")

    errs = dict.fromkeys(VARIANTS + (EXACT,), 0.0)
    scene_arrays, scene_name = load_cornell()
    s = T.init(0, SIZE, SIZE, 0, *scene_arrays, cam_origin=CAM_ORIGIN,
               device=device)
    log("kernels", f"scene {scene_name}: {s.scene.tris.shape[0]} triangles, "
        f"{s.scene.accel.chunk_bounds.shape[0]} chunk(s) of "
        f"{s.scene.accel.coeffs.shape[1] // s.scene.accel.chunk_bounds.shape[0]}")
    cornell = phase_kernels(ik, intersect, s, device, errs, card)
    del s
    s, launches, cornell_mean = phase_main(T, integrator, ik, scene_arrays,
                                           card, device)
    phase_reference(T, scene_arrays, device)
    phase_breakdown(integrator, ik, s, card, ("closest_hit", "any_hit"),
                    one_chunk=True)
    del s
    torch.cuda.empty_cache()
    big_launches, times = phase_bigscene(T, integrator, ik, intersect, card,
                                         device, errs, cornell_mean)
    launches.update({k: big_launches[k] for k in
                     ("closest_hit_streamed", "any_hit_streamed")})
    torch.cuda.empty_cache()
    k5 = phase_recip(device, card)
    torch.cuda.empty_cache()
    lidar_launches, capture_k1 = phase_lidar(T, integrator, ik, scene_arrays,
                                             card, device, errs)
    log("lidar", f"capture launches {lidar_launches}")
    cornell["closest_hit"].update(
        {f"capture_{f}": v for f, v in capture_k1.items()})

    fields = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "timed_at", "host_us",
              "library_host_us", "graph_ms", "library_graph_ms")
    kernels = [{"name": f"{k}_kernel", "route": "cuda",
                "source": "tracer_tpu_torch/csrc/intersect.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": errs[k], **times[k],
                **{f"cornell_{f}": v for f, v in cornell.get(k, {}).items()}}
               for k in VARIANTS + (EXACT,)]
    # the exact kernel is a check, not a kernel of the path: its one
    # launch in the main path's window is the smoke run's own
    kernels[-1]["on_path"] = False
    kernels.append({"name": "approx_reciprocal_kernel", "route": "cuda",
                    "source": "tracer_tpu_torch/csrc/recip.cu",
                    "replaces": "benchmarks/measure_recip.py:30",
                    **{k: k5[k] for k in fields}})
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
