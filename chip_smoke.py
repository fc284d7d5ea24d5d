#!/usr/bin/env python3
"""Smoke test of tracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout. Phases, each printed on its own line;
any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc-builds csrc/intersect.cu, csrc/recip.cu and
              csrc/shade.cu from the checkout into one library; counts
              each kernel's shared-memory load instructions in cuobjdump
              -sass of it (those of
              K1, K2, K3 and K4 are their scan loops', one triangle per
              iteration: 10 LDS.128 in each copy of the loop the compiler
              emitted, and no narrower load, or the phase fails); K1's
              registers and spills as ptxas printed them; K6 and K7 (the
              shading) read no shared memory
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
  4. main     the port's main path, through the API, which runs the
              pooled render (integrator.render_pooled: a lane whose path
              has ended takes the next (sample, pixel) work item): init a
              512x512 Cornell box, sample_n_frames(s, 17) (16 spp), timed,
              with its rays_traced, iterations, pool lanes P and the live
              share of its lane-iterations; 3 x step_render; checks the
              image and that every kernel launched and no plain intersect
              or shading version ran, K6 and K7 once a bounce (as often
              as K3), their counts set to 0 just before the window;
              inside the same window the exact kernel runs once on the
              camera rays, and K1's hits on them, taken before
              the window, must equal its own. Then the pool again from the
              same seed (image bit for bit) and render_frames (spp whole
              wavefronts, the plain per-frame version) at the same 16 spp
              on the same state, timed beside it: rays_traced equal
              exactly, the colour image within rtol 1e-5 (summation
              order); a 32x32 render is held against the same render on
              the CPU
  5. breakdown  one 16-spp pool render of the main path under
              torch.profiler (utils/profiling.device_trace): device busy
              share of the wall, device ops per pool iteration, each
              kernel's device time, and per pool iteration the live share
              of the lanes and the closest-hit kernel's device ms; for the
              one-chunk box also the wrapper call on the lanes as they
              come and with the dead lanes partitioned first (sort,
              gather, kernel, two scatters); then K1 and K3 on the
              queries of pool iterations 0, 1, every 6th and the last of
              that render as the pool hands them
              (2,097,152 lanes of fresh primaries among bounce rays, dead
              lanes at tmax 0, and their 4,194,304 shadow lanes) against
              the plain version on every lane and against the exact
              kernel on every lane, and both timed on the queries of one
              iteration, wrapper call and launch alone, beside the plain
              version and the bound of the same inputs: the ms, plain_ms
              and bound_ms of the kernels line
  6. shade    K6 and K7 (csrc/shade.cu, the ops shade_prepare and
              shade_finish) on the operands pool iteration 1 of a 16-spp
              pool render hands them (2,097,152 lanes), for the Cornell
              render (config 0, 512x512) and the capture (config 2,
              640x480, the fan per lane): against their plain version run
              on the card on the same operands, every output bit for bit
              on every lane; each timed as the op (wrapper) and as its
              launch alone, beside the plain version and the bound of the
              bytes its operands move: the ms, alone_ms, plain_ms and
              bound_ms of the kernels line
  7. bigscene the big-scene path on subdivisions of the Cornell box
              (the same surfaces and materials), run as: the render and
              its breakdown (timed), the checks that time nothing (beside
              phase 15's exports, with phase 11), the timings; all four
              kernels on
              subdivide(cornell_like, 5) (22,528 triangles, 88 chunks)
              and on cornell-sub6 = subdivide(cornell_like, 6) (90,112
              triangles, 352 chunks, streamed), each resident and
              streamed, with and without the ray permutation, against
              the plain version on a strided subset of 32,768 lanes; a
              hit-for-hit check of 8,192 rays on subdivide(cornell_like,
              8) (1,441,792 triangles); the 512x512 16-spp render of
              cornell-sub6 through init / sample_n_frames (the pool, with
              render_frames at 16 spp beside it, held to it as in phase
              4), whose image must pass the Cornell checks and lie
              within 3% of the Cornell image's mean; the breakdown of one
              16-spp cornell-sub6 pool render, with K2 and K4 on the
              queries of the iterations phase 5 picks (524,288 sorted
              lanes, 1,048,576 shadow lanes)
              against the plain version on a strided 8,192 of the lanes
              and against the exact kernel on every lane, and both timed
              on one iteration's queries as in phase 5; its chunk
              schedule statistics; each of the four kernels timed at
              cornell-sub6's per-frame shapes (262,144 first-bounce rays,
              where the kernels' history was measured), wrapper
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
  8. recip    K5: the approximate-reciprocal probe
              (utils/measure_recip.measure) at n = 2^20 on the card, its
              JSON line, max_rel within APPROX_RECIP_REL = 2^-8 and within
              RCP_APPROX_REL = 2^-22 (rcp.approx's documented 1 ulp); K5
              against its plain version at 2^20 + 1, 2^20 + 3 and on the
              offset view x[1:]; K5, torch.reciprocal and the plain version
              timed at 2^20 and 2^26 beside the bandwidth bound, and for
              K5 and torch.reciprocal the host microseconds per call and
              the device time alone (calls replayed from a CUDA graph)
  9. lidar    the LiDAR capture of the reference's demo-save: init(conf
              2) at 640x480, sample_points_n(s, 100) (the pool), timed,
              with rays_traced, iterations, P and live share taken from
              the same run; the points' window, miss encoding and return
              share, the nonce, K1/K3 launched and no plain version; at 8
              of the 100 spp the pool twice (image and points bit for
              bit) and render_frames beside it (rays_traced, distance
              image and points equal exactly); K1 and K3 against their
              plain versions
              on every query of one 1-spp frame of the capture (307,200
              closest-hit rays and 614,400 shadow lanes per bounce, most
              of them aimed at the transmitter fan), K1 against the exact
              kernel on every closest query of it, and K3 against the
              exact kernel's hits on every shadow lane of it; K1 timed at
              the capture's shapes; a 32x32 8-spp capture
              against the CPU; 3 distance-mode steps; the flash (conf 1)
              against conf 0 on the box with its emission killed; the
              breakdown of one 16-spp pool capture, with K1 and K3 on
              the queries of the iterations phase 5 picks (2,097,152 and
              4,194,304 lanes) against
              the plain version and the exact kernel as in phase 5
 10. lbvh     accel="lbvh" (plain torch) built on the card for the Cornell
              box and subdivide(cornell_like, 3): closest hit on the
              camera and first-bounce rays and any hit on the 2N shadow
              lanes against the dense accel (K1/K3): ok equal off boundary
              lanes, t within 1e-5 relative, another triangle only inside
              the tie band (kernel_cases.boundary_lanes at 1e-5; a lane
              that differs off it must be decided by a grazing triangle,
              |a| <= 8 x TRI_EPS in float64, and is printed with that
              triangle's |a|, u, v and t); a 64x64 4-spp
              render whose mean lies within 3% of the dense accel's; build
              ms and ms per query (utils/profiling.PhaseTimer)
 11. checkpoint  a state saved (utils/checkpoint.py) and loaded on the
              card, with either accel, resumes the next step bit for bit
              (run after phase 7's checks, beside phase 15's exports)
 12. parallel parallel/render.py on PARALLEL_RANKS gloo ranks sharing the
              card (parallel/local.run_sharded spawns them after the
              parent built the kernels): render_pooled_sharded of the
              512x512 Cornell box at 16 spp over (2, 2), 3 step_sharded
              frames with the accumulation on over (4, 1), and the
              640x480 100-spp capture through sample_points_sharded over
              (2, 2), each held to the single-process call on the same
              card (tile-only bit for bit, else within rtol 1e-5 with the
              differing pixels printed; sample-sharded within rtol 1e-5;
              points: returns and positions equal, intensity within rtol
              1e-6), each rank's K1/K3 launches > 0 and no plain
              intersect version on any rank, each sharded wall beside the
              single call's; then one NCCL group of world size 1 that
              reduces a tensor on the card and renders through a (1, 1)
              mesh, bit for bit the single render
 13. viewer   frontends/interactive.py headless through its CLI at
              800x600 for 16 frames: frames per second, its last frame
              equal to that of 32 step + render calls of the API
 14. native   native/objloader.cpp built with g++ (utils/native.py; its
              build time), an OBJ + MTL written from
              subdivide(cornell_like, 5) read back natively and by the
              Python loader (equal to each other and to the arrays
              written), and the sharded capture's points written as PCD
              natively and by utils/pcd.py, byte for byte equal
 15. aot      the exported step (utils/aot.py) of four states, each with
              the accumulation on and one frame taken: the 512x512
              Cornell box (K1/K3), cornell-sub6 at 512x512 (K2/K4), the
              640x480 config-2 capture in distance mode (K1/K3) and a
              128x128 LBVH box (no kernel); the four exported at once by
              processes of their own at the lowest priority, started
              before phase 7's checks and waited for after them and
              phase 11, beside work that times nothing (seconds and bytes
              of each), then
              one fresh process that loads each state from a checkpoint
              and its artifact (seconds) and steps it 3 times (each wall
              closed by a synchronise), never importing
              engine.integrator; its images, n_frames and nonce held bit
              for bit to 3 api.step calls from the same state in this
              process (their walls printed beside), the kernels each
              state needs launched from the exported step and no plain
              version called
 16. result   a JSON line of the kernels (K1-K7 and the exact
              kernel), then the last line
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
K6 and K7 are bound by their bytes alone (shade_bytes: 185 bytes a lane
for K6 without a fan, 24 for K7); their operations are not counted.
"""

import contextlib
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
# A pool query (P lanes, 2P shadow lanes) is held to the plain version on
# every lane, PLAIN_SLICE lanes at a time, while lanes x triangles stays
# within PLAIN_PAIRS; past that (cornell-sub6) on a strided POOL_SUBSET of
# the lanes of every query. The exact kernel takes every lane either way.
PLAIN_PAIRS = 1 << 30
PLAIN_SLICE = 1 << 19
POOL_SUBSET = 8_192
POOL_TIMED = 1      # the pool iteration whose queries are timed: the first
                    # with fresh primaries among bounce lanes
# The pool iterations whose queries are held to the plain version and the
# exact kernel: 0 (camera rays), 1 (fresh primaries among bounce rays),
# every POOL_CHECK_STRIDE-th and the last (the drain's few live lanes).
POOL_CHECK_STRIDE = 6
MEAN_REL = 0.03     # cornell-sub6 image mean against the Cornell image's
PROFILE_SPP = 16    # samples per pixel of a profiled pool render
# subdivision levels of cornell_like: the resident multi-chunk scene, the
# slice's scene (cornell-sub6) and the hit-for-hit check
RESIDENT_LEVELS, SLICE_LEVELS, CHECK_LEVELS = 5, 6, 8
LBVH_LEVELS = 3     # subdivide(cornell_like, 3), 1,408 triangles, for the LBVH
# The LBVH scores a triangle from its vertices, the dense accel from
# precomputed coefficient rows: on a grazing ray, whose determinant a is
# near TRI_EPS = 1e-5, an f32 error of 1e-8 in a numerator is 1e-3 in u,
# v or t. A lane where the two accels differ off the REL band is excused
# only when a triangle that decides it (one whose validity flips inside
# the GRAZE_REL band, or one of the two nearest candidates of a closest
# query) has |a| <= GRAZE_A * TRI_EPS in float64; each such lane is
# printed with |a|, u, v and t of those triangles (grazing_lanes). On an
# H100 one shadow lane of 524,288 on subdivide(cornell_like, 3) does so:
# |a| = 5.154 x TRI_EPS, u + v = 1 - 9.2e-5 on one triangle and u =
# -9.2e-5 on its neighbour across the shared edge.
GRAZE_REL = 1e-3
GRAZE_A = 8.0
CAM_ORIGIN = (0.0, 0.8, 1.8)
VARIANTS = ("closest_hit", "closest_hit_streamed", "any_hit",
            "any_hit_streamed")
EXACT = "closest_hit_exact"   # the yardstick, never on the path
SHADE_KERNELS = ("shade_prepare", "shade_finish")   # K6, K7 (csrc/shade.cu)
REPLACES = {
    "closest_hit": "tracer_tpu/ops/pallas/intersect_kernel.py:429",
    EXACT: "tracer_tpu/ops/pallas/intersect_kernel.py:429",
    "closest_hit_streamed": "tracer_tpu/ops/pallas/intersect_kernel.py:589",
    "any_hit": "tracer_tpu/ops/pallas/intersect_kernel.py:497",
    "any_hit_streamed": "tracer_tpu/ops/pallas/intersect_kernel.py:704",
    # no TPU kernel: XLA fuses NEE + MIS and the BSDF step
    "shade_prepare": "tracer_tpu/engine/direct.py:144 (estimate_direct, up "
                     "to its query), tracer_tpu/engine/integrator.py:116 "
                     "(XLA-fused)",
    "shade_finish": "tracer_tpu/engine/direct.py:144 (estimate_direct, after "
                    "its query), :242 (XLA-fused)",
}
# Published H100 SXM rates (NVIDIA's data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
RECIP_SIZES = (1 << 20, 1 << 26)   # K5: the probe's n, and past the L2
# the reference's demo-save capture (frontends/save_demo.py defaults)
LIDAR_W, LIDAR_H, LIDAR_SPP = 640, 480, 100
LIDAR_CHECK_SPP = 8   # of them, where render_frames runs beside the pool
PARALLEL_RANKS = 4    # gloo ranks of the parallel phase, all on the one card
# the viewer's window at its defaults, and the frames it runs headless
VIEWER_W, VIEWER_H, VIEWER_FRAMES = 800, 600, 16
NATIVE_LEVELS = 5     # subdivide(cornell_like, 5): the native phase's OBJ
AOT_STEPS = 3         # steps of each exported and eager run of phase aot
AOT_LBVH_SIZE = 128   # the LBVH state of phase aot
AOT_TIMEOUT = 600     # seconds for a child process of phase aot


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


_T0 = time.perf_counter()


def clock(phase):
    """Print the seconds since the script began, at the end of a phase."""
    log("clock", f"{phase} done at {time.perf_counter() - _T0:.1f} s")


def tap(module, name, calls):
    """utils/kernel_timing.tap: within the block, each call of
    module.name also appends (args, kwargs, result) to calls."""
    from tracer_tpu_torch.utils import kernel_timing
    return kernel_timing.tap(module, name, calls)


@contextlib.contextmanager
def tap_call(module, name, index, keep):
    """Within the block, call number `index` (from 0) of module.name also
    appends (args, kwargs, result) to keep; the other calls keep nothing."""
    fn = getattr(module, name)
    calls = [0]

    def tapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if calls[0] == index:
            keep.append((args, kwargs, out))
        calls[0] += 1
        return out

    setattr(module, name, tapped)
    try:
        yield keep
    finally:
        setattr(module, name, fn)


def reset_path_counts(ik):
    """Set the launch and plain-call counts of K1-K4 and of the shading
    kernels K6/K7 to 0."""
    from tracer_tpu_torch.engine import shade
    ik.reset_counts()
    shade.reset_counts()


def path_counts(ik, phase):
    """(launches, plain_calls) of K1-K4 and K6/K7 since reset_path_counts.
    K6 and K7 launch once a bounce, as the any-hit query does on a scene
    with a light (K3 or K4), and no plain version runs; else this
    raises."""
    from tracer_tpu_torch.engine import shade
    launches = {**ik.launches, **shade.launches}
    plain = {**ik.plain_calls, **shade.plain_calls}
    bounces = launches["any_hit"] + launches["any_hit_streamed"]
    log(phase, f"shading kernels: launches {dict(shade.launches)}, plain "
        f"calls {dict(shade.plain_calls)}, any-hit launches {bounces}")
    if (not launches["shade_prepare"] == launches["shade_finish"] == bounces
            or bounces <= 0 or max(shade.plain_calls.values()) != 0):
        raise AssertionError("the shading kernels did not run once a bounce")
    return launches, plain


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
                        + SHADE_KERNELS
                        if f"{k}_kernel" in m.group(1)), m.group(1))
            flags = re.search(r"ILb(\d)ELb(\d)E", m.group(1))
            if cur.startswith("shade_prepare") and flags:
                cur += " (lights %s, transmitter %s)" % flags.groups()
            elif "ILb1E" in m.group(1):
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
    stage, 64-bit loads) and K5 are not held to it; K6 and K7 (the
    shading, one thread a lane) read no shared memory."""
    for k, c in loads.items():
        if k.startswith(SHADE_KERNELS):
            if c:
                raise AssertionError(f"{k} reads shared memory: {c}")
            continue
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


def plain_in_slices(ik, query, co, phi, tm, cb):
    """The plain version of `query` ("closest" or "any") and
    kernel_cases.boundary_lanes on the same lanes, PLAIN_SLICE lanes at a
    time (a lane's result does not depend on its neighbours). Returns
    (ref, (edge, tie)), ref as the plain version returns it."""
    import torch
    from tracer_tpu_torch.utils import kernel_cases as kc
    ref_fn = ik.closest_hit_ref if query == "closest" else ik.any_hit_ref
    refs, bands = [], []
    for j in range(0, phi.shape[1], PLAIN_SLICE):
        p = phi[:, j:j + PLAIN_SLICE].contiguous()
        t = tm[j:j + PLAIN_SLICE].contiguous()
        refs.append(ref_fn(co, p, t, cb))
        bands.append(kc.boundary_lanes(co, p, t, cb, rel=REL))
    band = tuple(torch.cat(x) for x in zip(*bands))
    if query == "any":
        return torch.cat(refs), band
    return tuple(torch.cat(x) for x in zip(*refs)), band


def checked_iterations(n):
    """The pool iterations of a render of n whose queries are checked."""
    return sorted(({0, 1, n - 1} | set(range(0, n, POOL_CHECK_STRIDE)))
                  & set(range(n)))


def check_pool_queries(ik, phase, label, closest, anyq, errs):
    """The closest- and any-hit queries of the pool iterations
    checked_iterations picks in one pool render, as the path hands them
    to the kernel wrappers (kernel_timing.pool_queries: P lanes of fresh
    primaries among bounce rays, dead lanes at tmax 0, and their 2P
    shadow lanes), against the plain version (on every lane, or on a
    strided POOL_SUBSET of them where lanes x triangles passes
    PLAIN_PAIRS) and against the exact kernel on every lane."""
    import torch
    if not closest or len(closest) != len(anyq):
        raise AssertionError(f"{label}: the pool render made no kernel "
                             f"queries")
    picked = checked_iterations(len(closest))
    log(phase, f"{label}: the queries of pool iterations {picked} of "
        f"{len(closest)} are checked")
    for query, queries in (("closest", closest), ("any", anyq)):
        for i in picked:
            co, phi, tm, cb, kw = queries[i]
            n = phi.shape[1]
            tm = torch.as_tensor(tm, dtype=torch.float32,
                                 device=phi.device).expand(n).contiguous()
            streamed = ik.streamed_variant(co.shape[1], kw.get("stream"))
            name = ik.variant_name(query, streamed)
            whole = n * co.shape[1] <= PLAIN_PAIRS
            lanes = (torch.arange(n, device=phi.device) if whole
                     else strided(n, phi.device, POOL_SUBSET))
            tag = (f"{label} pool iteration {i} ({int((tm > 0).sum())} of "
                   f"{n} lanes live; plain on {lanes.shape[0]})")
            ref, band = plain_in_slices(
                ik, query, co, phi if whole else phi[:, lanes].contiguous(),
                tm[lanes], cb)
            if query == "closest":
                bt, bi = ik.closest_hit(co, phi, tm, cb, **kw)
                err = compare_closest(phase, tag, (bt[lanes], bi[lanes]),
                                      ref, band)
                closest_equals_exact(
                    phase, tag, co, phi, tm, cb, streamed,
                    not streamed and ik.BLOCK == ik.EXACT_BLOCK,
                    max_sched=kw.get("max_sched", ik.MAX_SCHED))
            else:
                hit = ik.any_hit(co, phi, tm, cb, **kw)
                err = compare_any(phase, tag, hit[lanes], ref, band[0])
                any_equals_exact(phase, tag, co, phi, tm, cb, streamed)
            errs[name] = max(errs[name], err)
            del ref, band


def pool_query_times(ik, phase, label, closest, anyq, card):
    """The two kernels of a pool render timed on the queries of its
    iteration POOL_TIMED: wrapper call and launch alone
    (kernel_timing.kernel_times), the plain version on the same lanes
    (one call after two, PLAIN_SLICE lanes at a time) and the bound of
    the same inputs. Returns {kernel name: times}."""
    import torch
    from tracer_tpu_torch.utils import kernel_timing
    out = {}
    for query, queries in (("closest", closest), ("any", anyq)):
        co, phi, tm, cb, kw = queries[min(POOL_TIMED, len(queries) - 1)]
        n = phi.shape[1]
        tm = torch.as_tensor(tm, dtype=torch.float32,
                             device=phi.device).expand(n).contiguous()
        streamed = ik.streamed_variant(co.shape[1], kw.get("stream"))
        name = ik.variant_name(query, streamed)
        ref = ik.closest_hit_ref if query == "closest" else ik.any_hit_ref

        def plain():
            for j in range(0, n, PLAIN_SLICE):
                ref(co, phi[:, j:j + PLAIN_SLICE].contiguous(),
                    tm[j:j + PLAIN_SLICE].contiguous(), cb)

        live = int((tm > 0).sum())
        t = kernel_timing.kernel_times(query, co, phi, tm, cb, streamed)
        t["plain_ms"] = ms_per_call(plain, calls=1, rounds=1)
        t["bound_ms"], t["bound_by"] = query_bound(
            ik, query, f"{name} on {label}'s pool iteration {POOL_TIMED}",
            co, cb, phi, tm, card, phase=phase)
        t["library_ms"] = None
        t["timed_at"] = (f"{label}, the {'2P shadow' if query == 'any' else 'P'}"
                         f" lanes of pool iteration {POOL_TIMED}: {n} lanes, "
                         f"{live} live, as the path orders them")
        log(phase, f"time {name} on {t['timed_at']}: wrapper {t['ms']:.4f} "
            f"ms, launch alone {t['alone_ms']:.4f} ms = "
            f"{100 * t['bound_ms'] / t['alone_ms']:.1f}% of its bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms (median of {TIME_ROUNDS} rounds of "
            f"{TIME_CALLS} back-to-back calls; plain: one call after two, "
            f"in slices of {PLAIN_SLICE} lanes; on {card})")
        out[name] = t
    return out


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


def pool_lanes(integrator, s, spp):
    """P, the lanes of the pool that renders spp samples of state s."""
    w, h = s.sub_dims
    return integrator._pool_size(w * h, spp, integrator._scene_t_pad(s.scene))


def pool_line(integrator, s, spp, out, secs, card):
    """What a timed pool render printed: wall, rays, iterations, P, the
    live share of its lane-iterations."""
    p = pool_lanes(integrator, s, spp)
    rays, iters = out["rays_traced"], out["iters"]
    return (f"{secs:.3f} s, rays_traced={rays} (3 x active lanes per "
            f"iteration), {rays / secs / 1e6:.2f} Mrays/s, iters={iters}, "
            f"P={p} lanes, {100 * rays / (3 * p * iters):.2f}% of "
            f"lane-iterations live, on {card}")


def compare_pool_frames(phase, label, pool, frames, color):
    """The pool against render_frames on the same streams: rays_traced,
    the distance image and the points equal exactly, a colour image
    within rtol 1e-5 (summation order) on every pixel."""
    import torch
    if color:
        px = torch.isclose(pool["img"], frames["img"], rtol=1e-5,
                           atol=0.0).all(dim=-1)
    else:
        px = (pool["img"] == frames["img"]).all(dim=-1)
    equal = bool(px.all())
    msg = (f"{label}: pool against render_frames: rays_traced "
           f"{pool['rays_traced']} / {frames['rays_traced']}, "
           f"{'colour within rtol 1e-5' if color else 'distance image equal'}"
           f" on {int(px.sum())} of {px.numel()} pixels")
    if "points" in pool:
        same = torch.ones_like(pool["points"][1], dtype=torch.bool)
        for x, y in zip(pool["points"], frames["points"]):
            eq = x == y
            same &= eq.all(dim=0) if eq.dim() == 2 else eq
        equal &= bool(same.all())
        msg += f", points equal on {int(same.sum())} of {same.numel()}"
    log(phase, msg)
    if pool["rays_traced"] != frames["rays_traced"] or not equal:
        raise AssertionError(f"{label}: the pool differs from render_frames")


def render_cell(T, integrator, ik, s, phase, card, before=None, after=None):
    """One cell through the API: warm up, call before() if given, set the
    counts to 0, time sample_n_frames(s, 17) (the pool at 16 spp; its
    rays and iterations tapped from the same call), call after() if
    given and read the counts (K1-K4's and the shading kernels', which
    must launch once a bounce: as often as the any-hit query, with no
    plain version). Then, outside the window: the pool again
    from the same seed (bit for bit), and render_frames at the same 16
    spp on the same state, timed, held against the pool. Returns (image,
    launches, plain_calls, iters) of the API run."""
    import torch
    w, h = s.sub_dims
    color = s.render_mode == "color"
    args = (s.seed, s.nonce + 1, s.scene, s.cam, s.ambience, w, h,
            s.transmitter_kind, 16, s.render_mode)
    T.sample_n_frames(s, 1)   # warm-up: first launches, allocator
    if before is not None:
        before()
    torch.cuda.synchronize()
    reset_path_counts(ik)
    pooled = []
    t0 = time.perf_counter()
    with tap(integrator, "render_pooled", pooled):
        img = T.sample_n_frames(s, 17)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if after is not None:
        after()
        torch.cuda.synchronize()
    launches, plain = path_counts(ik, phase)
    if len(pooled) != 1:
        raise AssertionError("sample_n_frames did not run the pool once")
    out = pooled[0][2]
    log(phase, f"sample_n_frames(s, 17), the pool at {w}x{h} 16 spp: "
        + pool_line(integrator, s, 16, out, secs, card))
    again = integrator.render_pooled(*args)
    if (not torch.equal(again["img"], img)
            or again["rays_traced"] != out["rays_traced"]
            or again["iters"] != out["iters"]):
        raise AssertionError("two pool renders from one seed differ")
    del again
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = integrator.render_frames(*args)
    torch.cuda.synchronize()
    fsecs = time.perf_counter() - t0
    log(phase, f"render_frames {w}x{h} 16 spp on the same state: "
        f"{fsecs:.3f} s, {frames['rays_traced'] / fsecs / 1e6:.2f} Mrays/s; "
        f"the pool takes {secs / fsecs:.3f} of its wall; two pool renders "
        f"from one seed: bit for bit")
    compare_pool_frames(phase, f"{w}x{h} 16 spp", out, frames, color)
    return img, launches, plain, out["iters"]


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
    window = {}

    def rest_of_window():
        s2 = s
        for _ in range(3):
            s2, argb = T.step_render(s2)
            if (tuple(argb.shape) != (SIZE, SIZE)
                    or argb.dtype != torch.uint32):
                raise AssertionError(f"step_render gave {argb.dtype} "
                                     f"{tuple(argb.shape)}")
        # the yardstick's one launch inside the window: the path never
        # calls it, the smoke run holds the path's kernel to it
        window["ex_t"], _ = ik.closest_hit_exact(
            dense.coeffs, phi_cam, shapes.F32_HIGHEST, dense.chunk_bounds)
        window["argb"] = argb

    img, launches, plain, iters = render_cell(
        T, integrator, ik, s, "main", card,
        before=lambda: k1.extend(ik.closest_hit(
            dense.coeffs, phi_cam, shapes.F32_HIGHEST, dense.chunk_bounds)),
        after=rest_of_window)
    ex_t, argb = window["ex_t"], window["argb"]
    log("main", f"launches={launches} plain_calls={plain} (the 16-spp pool's "
        f"{iters} iterations, one launch each, and 3 step_render frames)")
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


def lane_bytes(x, n):
    """Bytes of operand x that a kernel over n lanes moves: each lane's
    values if the last axis runs over the lanes (n, or 2n for the packed
    shadow lanes), else x once (0 for an operand that is not a tensor)."""
    import torch
    if not isinstance(x, torch.Tensor):
        return 0
    if x.dim() and x.shape[-1] in (n, 2 * n) and x.stride(-1) != 0:
        return x.numel() * x.element_size()
    return x[..., :1].numel() * x.element_size()


def shade_bytes(name, args, outs, n):
    """The bytes K6 or K7 must move: each lane operand read once, each
    output written once; for K6 the light table once and, where the fan
    runs over the lanes (sectors (8, 9, n)), one sector's 36 bytes on the
    lanes that select it, n_trans / n_lights of them under the uniform
    select. (185 bytes a lane for K6 without a fan, 24 for K7.)"""
    if name == "shade_finish":
        return (sum(lane_bytes(x, n) for x in args[:6])
                + sum(lane_bytes(x, n) for x in outs))
    sectors = args[15]
    moved = sum(lane_bytes(x, n) for x in args[:14])
    moved += args[14].numel() * args[14].element_size()
    moved += sum(lane_bytes(x, n) for x in outs)
    if sectors is not None:
        n_trans = sectors.shape[0]
        n_lights = args[14].shape[0] + n_trans
        if sectors.stride(-1) != 0 and sectors.shape[-1] == n:
            moved += 36 * n * n_trans / n_lights
        else:
            moved += sectors.numel() * sectors.element_size()
    return moved


def phase_shade(T, integrator, scene_arrays, card, device):
    """K6 and K7 (csrc/shade.cu) at the main path's shapes: the operands
    that pool iteration POOL_TIMED of a 16-spp pool render hands to
    engine/shade.prepare and finish, P = 2,097,152 lanes of fresh
    primaries among bounce rays, for the render (config 0, 512x512) and
    the capture (config 2, 640x480, the scanning fan per lane). Each op
    against its plain version run on the card on the same operands: every
    output equal bit for bit on every lane. Then each timed as the op
    (wrapper) and as its launch alone (the library's entry point called
    again with the op's own operands), beside the plain version and the
    bound of the bytes its operands move. Returns name -> fields of the
    kernels line (the capture's under capture_*)."""
    import ctypes
    import torch
    from tracer_tpu_torch.engine import shade
    from tracer_tpu_torch.ops import cuda_lib
    ops = torch.ops.tracer_tpu_torch
    tris, tm, mats = scene_arrays
    out = {k: {} for k in SHADE_KERNELS}
    for conf, (w, h), tag in ((0, (SIZE, SIZE), ""),
                              (2, (LIDAR_W, LIDAR_H), "capture_")):
        s = T.init(0, h, w, conf, tris, tm, mats, cam_origin=CAM_ORIGIN,
                   device=device)
        prep_calls, fin_calls = [], []
        with tap_call(shade, "prepare", POOL_TIMED, prep_calls), \
                tap_call(shade, "finish", POOL_TIMED, fin_calls):
            integrator.render_pooled(
                s.seed, s.nonce + 1, s.scene, s.cam, s.ambience, w, h,
                s.transmitter_kind, PROFILE_SPP, s.render_mode,
                with_points=conf == 2)
        torch.cuda.synchronize()
        (pa, pkw, _), = prep_calls
        (fa, fkw, _), = fin_calls
        args = shade.prepare_args(*pa, **pkw)
        fin = shade.finish_args(*fa, **fkw)
        n = args[0].shape[0]
        what = {"shade_prepare": (args, lambda: ops.shade_prepare(*args),
                                  lambda: shade._prepare_plain(*args)),
                "shade_finish": (fin, lambda: ops.shade_finish(*fin),
                                 lambda: shade._finish_plain(*fin))}
        for name, (a, op, plain) in what.items():
            got, want = op(), plain()
            got = got if isinstance(got, (tuple, list)) else (got,)
            want = want if isinstance(want, (tuple, list)) else (want,)
            torch.cuda.synchronize()
            unequal, max_abs = 0, 0.0
            for g, r in zip(got, want):
                gb = g.view(torch.int32) if g.dtype == torch.float32 else g
                rb = r.view(torch.int32) if r.dtype == torch.float32 else r
                unequal += int((gb != rb).sum())
                if g.is_floating_point():
                    d = (g - r).abs().nan_to_num(0.0)
                    max_abs = max(max_abs, float(d.max()))
            hits = int(((fin[2] & shade.HIT) != 0).sum())
            log("shade", f"{name} at config {conf}, pool iteration "
                f"{POOL_TIMED} ({n} lanes, {int(args[1].sum())} alive, "
                f"{hits} hit): against the plain version on the card, "
                f"{unequal} values not equal bit for bit over {len(got)} "
                f"outputs, max abs {max_abs:.3e}")
            if unequal:
                raise AssertionError(f"{name} differs from its plain version")
            # the launch alone: the op's own operands and outputs, the
            # latter held while its entry point is called again
            seen = {}
            launch = shade._launch

            def spy(k, ptrs, ints, dev):
                seen[k] = (list(ptrs), list(ints))
                return launch(k, ptrs, ints, dev)

            shade._launch = spy
            try:
                held = op()
            finally:
                shade._launch = launch
            ptrs, ints = seen[name]
            entry = getattr(shade.build(), f"{name}_launch")
            p = (ctypes.c_void_p * len(ptrs))(*ptrs)
            q = (ctypes.c_longlong * len(ints))(*ints)
            stream = cuda_lib.raw_stream(args[0].device.index)

            def alone():
                if entry(p, q, len(ptrs), len(ints), stream):
                    raise RuntimeError(f"{name} launch failed")

            t = {"ms": ms_per_call(op), "alone_ms": ms_per_call(alone),
                 "plain_ms": ms_per_call(plain, calls=5, rounds=3)}
            del held
            moved = shade_bytes(name, a, got, n)
            t["bound_ms"], t["bound_by"] = bound(moved, 0)
            t["timed_at"] = (f"pool iteration {POOL_TIMED} of a "
                             f"{PROFILE_SPP}-spp {w}x{h} config-{conf} "
                             f"render, {n} lanes")
            log("shade", f"time {name} at config {conf}: wrapper "
                f"{t['ms']:.4f} ms, alone {t['alone_ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({moved / n:.1f} B a lane at 3.35 TB/s), share of the "
                f"bound alone {100 * t['bound_ms'] / t['alone_ms']:.1f}% "
                f"(median of {TIME_ROUNDS} rounds of {TIME_CALLS} "
                f"back-to-back calls, on {card})")
            out[name].update({f"{tag}{f}": v for f, v in t.items()})
            if not tag:
                out[name]["max_abs_err"] = max_abs
            del got, want
        del prep_calls, fin_calls, args, fin, what, s
        torch.cuda.empty_cache()
    return out


def busy_us(spans):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def phase_breakdown(integrator, ik, s, card, names, errs, label,
                    phase="breakdown", one_chunk=False, with_points=False,
                    before_checks=None):
    """Where the time of one PROFILE_SPP-spp pool render goes, for the
    kernels `names` (closest first) that the pool launches once per
    iteration; one_chunk: also time the dead-lane partition per
    iteration. Then the two kernels timed on the queries of one iteration
    of that render (pool_query_times), whose times it returns, and the
    queries of several iterations against the plain version and the
    exact kernel (check_pool_queries), which time nothing: before_checks
    is called between the two.
    torch.profiler (utils/profiling.device_trace) traces the
    card; the device is busy over the union of its kernel and copy
    intervals, each taken once, and the share is of the host-clock wall
    of the same profiled render (the profiler's own host cost lengthens
    that wall, so the share is a lower bound)."""
    import torch
    from torch.autograd import DeviceType
    from tracer_tpu_torch.utils import profiling
    w, h = s.sub_dims

    def render():
        out = integrator.render_pooled(
            s.seed, s.nonce + 1, s.scene, s.cam, s.ambience, w, h,
            s.transmitter_kind, PROFILE_SPP, s.render_mode,
            with_points=with_points)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    out = render()
    plain_wall = time.perf_counter() - t0
    n0 = ik.launches[names[0]]
    with profiling.device_trace() as prof:
        t0 = time.perf_counter()
        render()
        wall = time.perf_counter() - t0
    iters = ik.launches[names[0]] - n0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e6
    log(phase, f"{PROFILE_SPP}-spp {w}x{h} pool render under torch.profiler: "
        f"wall {wall:.4f} s ({plain_wall:.4f} s unprofiled), {iters} pool "
        f"iterations launched ({out['iters']} with an active lane, P="
        f"{pool_lanes(integrator, s, PROFILE_SPP)}), {len(dev)} device ops "
        f"({len(dev) / iters:.0f} per iteration), device busy {busy:.4f} s = "
        f"{100 * busy / wall:.1f}% of the profiled wall, on {card}")
    spans = {}
    for k in names:
        ks = [e.time_range.elapsed_us() for e in sorted(
            (e for e in dev if f"{k}_kernel" in e.name),
            key=lambda e: e.time_range.start)]
        if len(ks) != iters:
            raise AssertionError(f"{len(ks)} {k}_kernel spans in the trace, "
                                 f"{iters} pool iterations")
        log(phase, f"{k}_kernel: {len(ks)} launches, "
            f"{sum(ks) / 1e3:.3f} ms on the device "
            f"({sum(ks) / len(ks) / 1e3:.4f} ms each), "
            f"{100 * sum(ks) / 1e6 / busy:.1f}% of device busy time")
        spans[k] = ks
    del prof, dev
    # per pool iteration: the live share of the lanes (the same render
    # again, its closest queries tapped at the wrapper) and the closest
    # kernel's span in the trace above
    from tracer_tpu_torch.utils import kernel_timing
    queries, shadow = kernel_timing.pool_queries(integrator, s, PROFILE_SPP,
                                                 with_points=with_points)
    if len(queries) != iters:
        raise AssertionError(f"{len(queries)} closest queries in the render, "
                             f"{iters} pool iterations")
    live = [float((q[2] > 0).float().mean()) for q in queries]
    log(phase, f"per pool iteration, live share of {queries[0][1].shape[1]} "
        f"lanes / {names[0]}_kernel ms in the profiled render: "
        + ", ".join(f"{i}: {100 * p:.2f}% / {t / 1e3:.4f}"
                    for i, (p, t) in enumerate(zip(live, spans[names[0]])))
        + f"; lane-iterations live {100 * sum(live) / len(live):.2f}%")
    if one_chunk:
        rows = kernel_timing.bounce_times(queries, partition=True)
        log(phase, "per pool iteration on the one-chunk box, ms: kernel "
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
    times = pool_query_times(ik, phase, label, queries, shadow, card)
    if before_checks is not None:
        before_checks()
    check_pool_queries(ik, phase, label, queries, shadow, errs)
    return times


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


def phase_big_kernels(ik, intersect, states, errs):
    """(1) all four kernels on the states of subdivide(cornell_like, 5)
    and of cornell-sub6 at the main path's 512x512 shapes."""
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    for levels, s in states.items():
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
                   cornell_mean, before_checks=None, after_checks=None):
    """The big-scene path: the cornell-sub6 render (timed) and its
    breakdown (timed), then the checks that time nothing (the breakdown's
    queries, the four kernels on two subdivisions, the hit-for-hit check),
    then the kernels timed at the per-frame shapes. before_checks and
    after_checks are called around the checks."""
    import torch
    from tracer_tpu_torch.utils import kernel_timing
    states = {levels: kernel_timing.sub_state(levels, SIZE, device)
              for levels in (RESIDENT_LEVELS, SLICE_LEVELS)}

    # (3) the slice's render: cornell-sub6 through the entry points
    s = states[SLICE_LEVELS]
    img, launches, plain, iters = render_cell(T, integrator, ik, s,
                                              "bigscene", card)
    log("bigscene", f"cornell-sub6 launches={launches} plain_calls={plain} "
        f"({iters} pool iterations with an active lane)")
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

    clock("bigscene render")
    # (4) breakdown and schedule statistics of one 16-spp pool render
    pool_times = phase_breakdown(
        integrator, ik, s, card, ("closest_hit_streamed", "any_hit_streamed"),
        errs, "cornell-sub6", phase="bigscene", before_checks=before_checks)
    schedule_stats(ik, intersect, s)
    clock("bigscene breakdown")
    phase_big_kernels(ik, intersect, states, errs)
    del states[RESIDENT_LEVELS]
    torch.cuda.empty_cache()
    phase_big_check(ik, intersect, device, errs)
    torch.cuda.empty_cache()
    clock("bigscene kernels")
    if after_checks is not None:
        after_checks()
    # (5) timing of the four kernels at cornell-sub6's per-frame shapes
    return launches, phase_big_timing(ik, s, card), pool_times


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
    pooled = []
    reset_path_counts(ik)
    t0 = time.perf_counter()
    with tap(integrator, "render_pooled", pooled):
        s2, pts = T.sample_points_n(s, LIDAR_SPP)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, plain = path_counts(ik, "lidar")
    if len(pooled) != 1:
        raise AssertionError("sample_points_n did not run the pool once")
    out = {k: v for k, v in pooled[0][2].items() if k != "points"}
    del pooled
    has = pts[..., 3] > 0
    share = float(has.float().mean())
    log("lidar", f"sample_points_n {LIDAR_W}x{LIDAR_H} x {LIDAR_SPP} spp "
        f"(config 2, {s.transmitter_kind} transmitter), the pool: "
        + pool_line(integrator, s, LIDAR_SPP, out, secs, card)
        + f"; returns {100 * share:.2f}% of pixels; launches={launches} "
        f"plain_calls={plain}")
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
    torch.cuda.empty_cache()

    # the pool twice and render_frames at LIDAR_CHECK_SPP of the capture's
    # 100 spp (the per-frame side is the slow one), same state and streams
    args = (s.seed, s.nonce, s.scene, s.cam, s.ambience, LIDAR_W, LIDAR_H,
            s.transmitter_kind, LIDAR_CHECK_SPP, s.render_mode)
    runs = []
    for fn in (integrator.render_pooled, integrator.render_pooled,
               integrator.render_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(fn(*args, with_points=True))
        torch.cuda.synchronize()
        runs[-1]["secs"] = time.perf_counter() - t0
    pa, pb, fr = runs
    if (not torch.equal(pa["img"], pb["img"])
            or not all(torch.equal(x, y)
                       for x, y in zip(pa["points"], pb["points"]))
            or pa["rays_traced"] != pb["rays_traced"]):
        raise AssertionError("two pool captures from one seed differ")
    log("lidar", f"{LIDAR_W}x{LIDAR_H} x {LIDAR_CHECK_SPP} spp: the pool "
        + pool_line(integrator, s, LIDAR_CHECK_SPP, pa, pa["secs"], card)
        + f"; again {pb['secs']:.3f} s, image and points bit for bit; "
        f"render_frames {fr['secs']:.3f} s, "
        f"{fr['rays_traced'] / fr['secs'] / 1e6:.2f} Mrays/s")
    compare_pool_frames("lidar", f"capture at {LIDAR_CHECK_SPP} spp", pa, fr,
                        False)
    del runs, pa, pb, fr
    clock("lidar capture")
    capture_k1 = check_capture_queries(ik, integrator, s, card, errs)
    torch.cuda.empty_cache()
    clock("lidar queries")

    # a 32x32 8-spp capture on the card against the same on the CPU
    dists = []
    for dev in (device, "cpu"):
        sm = T.init(0, 32, 32, 2, tris, tm, mats, cam_origin=CAM_ORIGIN,
                    device=dev)
        o = integrator.render_pooled(sm.seed, sm.nonce, sm.scene, sm.cam,
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

    pool_times = phase_breakdown(
        integrator, ik, s, card, ("closest_hit", "any_hit"), errs,
        "the capture", phase="lidar", with_points=True)
    return launches, capture_k1, pool_times


# ---------------------------------------------------------------------------
# the LBVH accel and the checkpoint

def grazing_lanes(label, mask, dense, phi, tmax, closest):
    """Of the lanes in mask (where the LBVH and the dense accel differ
    off the REL band), those a grazing triangle decides: (N,) bool. In
    float64, from the coefficient rows, over every triangle of the lanes
    in mask: a lane's deciding triangles are those whose validity flips
    when each test moves by GRAZE_REL and, for a closest query, its two
    nearest candidates; the lane is excused when one of them has |a| <=
    GRAZE_A * TRI_EPS. Prints |a|, u, v and t of the deciding triangles
    of up to 8 such lanes."""
    import torch
    from tracer_tpu_torch.ops import shapes
    idx = torch.nonzero(mask)[:, 0]
    out = torch.zeros_like(mask)
    if not idx.numel():
        return out
    co, cb = dense.coeffs, dense.chunk_bounds
    c = co.shape[1] // cb.shape[0]
    p64 = phi[:, idx].double()
    tm = torch.as_tensor(tmax, dtype=torch.float32, device=phi.device
                         ).double().expand(phi.shape[1])[idx]
    parts = [co[:, ci * c:(ci + 1) * c].reshape(4 * c, 10).double() @ p64
             for ci in range(cb.shape[0])]
    a, nt, nu, nv = (torch.cat([p[k * c:(k + 1) * c] for p in parts])
                     for k in range(4))
    aa = a.abs()
    inv_a = 1.0 / torch.where(a == 0, 1.0, a)
    t, u, v = nt * inv_a, nu * inv_a, -nv * inv_a
    tol_t = GRAZE_REL * torch.clamp_min(t.abs(), 1.0)

    def tests(s):  # s = +1 loosens every test, -1 tightens it
        return ((aa >= shapes.TRI_EPS * (1 - s * GRAZE_REL))
                & (u >= -s * GRAZE_REL) & (v >= -s * GRAZE_REL)
                & (u + v <= 1 + s * GRAZE_REL)
                & (t > -s * tol_t) & (t < tm + s * tol_t))

    loose = tests(1.0)
    deciding = loose & ~tests(-1.0)
    if closest:
        cand = torch.where(loose, t, float("inf"))
        near = torch.topk(cand, min(2, cand.shape[0]), dim=0, largest=False)
        deciding |= torch.zeros_like(loose).scatter_(
            0, near.indices, torch.isfinite(near.values))
    least = torch.where(deciding, aa, float("inf")).amin(dim=0)
    out[idx] = least <= GRAZE_A * shapes.TRI_EPS
    for k in range(min(8, idx.shape[0])):
        tris = torch.nonzero(deciding[:, k])[:4, 0].tolist()
        log("lbvh", f"{label}: lane {int(idx[k])} differs off the {REL} "
            f"band (tmax {float(tm[k]):.6g}); deciding triangles in float64"
            + (": none" if not tris else "".join(
                f"; storage index {j}: |a| = {float(aa[j, k]):.4e} = "
                f"{float(aa[j, k]) / shapes.TRI_EPS:.3f} x TRI_EPS, u = "
                f"{float(u[j, k]):.6e}, v = {float(v[j, k]):.6e}, t = "
                f"{float(t[j, k]):.6e}" for j in tris))
            + f"; excused (|a| <= {GRAZE_A:g} x TRI_EPS): {bool(out[idx[k]])}")
    return out


def phase_lbvh(T, integrator, intersect, scene_arrays, card, device):
    """accel="lbvh" on the card (plain torch, no hand kernel) against the
    dense accel (K1/K3): the Cornell box and subdivide(cornell_like, 3),
    on the camera rays, the first-bounce rays and the 2N shadow lanes of
    kernel_cases.render_rays at 512x512."""
    import torch
    from tracer_tpu_torch.models import scene as scene_mod
    from tracer_tpu_torch.ops import bvh as bvh_mod
    from tracer_tpu_torch.ops import shapes
    from tracer_tpu_torch.utils import kernel_cases as kc
    from tracer_tpu_torch.utils import profiling
    for label, arrays in (("Cornell", scene_arrays),
                          ("cornell-sub3", cornell_sub(LBVH_LEVELS))):
        timer = profiling.PhaseTimer(device)
        with timer.phase("build"):
            tree = bvh_mod.build(torch.as_tensor(arrays[0], device=device))
        del tree
        sd = T.init(0, SIZE, SIZE, 0, *arrays, cam_origin=CAM_ORIGIN,
                    accel="dense", device=device)
        sl = T.init(0, SIZE, SIZE, 0, *arrays, cam_origin=CAM_ORIGIN,
                    accel="lbvh", device=device)
        if not isinstance(sl.scene.accel, bvh_mod.LBVH):
            raise AssertionError("accel='lbvh' did not build an LBVH")
        dense = sd.scene.accel
        cam, first, (so, sdir, st) = kc.render_rays(sd)
        for name, (o, d) in (("camera", cam), ("first-bounce", first)):
            with timer.phase(f"closest {name}"):
                ok_l, t_l, i_l, _, _ = scene_mod.closest_hit(
                    sl.scene, shapes.F32_HIGHEST, o, d)
            ok_d, t_d, i_d, _, _ = scene_mod.closest_hit(
                sd.scene, shapes.F32_HIGHEST, o, d)
            phi = intersect.ray_features_t(o, d)
            edge, tie = kc.boundary_lanes(dense.coeffs, phi,
                                          shapes.F32_HIGHEST,
                                          dense.chunk_bounds)
            both = ok_l & ok_d
            # the LBVH returns input indices, the dense accel storage ones
            i_d_in = dense.perm[torch.where(ok_d, i_d, 0).long()]
            other = both & (i_l != i_d_in)
            off = (((ok_l != ok_d) & ~edge)
                   | (both & ~edge
                      & ~torch.isclose(t_l, t_d, rtol=REL, atol=0.0))
                   | (other & ~tie & ~edge))
            bad = off & ~grazing_lanes(f"{label} closest_hit, {name} rays",
                                       off, dense, phi, shapes.F32_HIGHEST,
                                       True)
            log("lbvh", f"{label} closest_hit on {o.shape[1]} {name} rays: "
                f"{int(ok_l.sum())} hits (dense {int(ok_d.sum())}), ok "
                f"differs on {int((ok_l != ok_d).sum())} lanes, another "
                f"triangle on {int(other.sum())}; ok, t (rtol {REL}) or the "
                f"triangle differ off the {REL} band on {int(off.sum())} "
                f"lanes, not decided by a grazing triangle on "
                f"{int(bad.sum())}")
            if int(bad.sum()):
                raise AssertionError(f"{label}: the LBVH's closest hit "
                                     f"disagrees with the dense accel's")
        with timer.phase("any"):
            hit_l = scene_mod.any_hit(sl.scene, st, so, sdir)
        hit_d = scene_mod.any_hit(sd.scene, st, so, sdir)
        phi = intersect.ray_features_t(so, sdir)
        edge, _ = kc.boundary_lanes(dense.coeffs, phi, st,
                                    dense.chunk_bounds)
        off = (hit_l != hit_d) & ~edge
        bad = off & ~grazing_lanes(f"{label} any_hit", off, dense, phi, st,
                                   False)
        log("lbvh", f"{label} any_hit on {so.shape[1]} shadow lanes: "
            f"{int(hit_l.sum())} occluded (dense {int(hit_d.sum())}), differs "
            f"on {int((hit_l != hit_d).sum())} lanes, {int(off.sum())} off "
            f"the {REL} band, {int(bad.sum())} not decided by a grazing "
            f"triangle")
        if int(bad.sum()):
            lanes = torch.nonzero(bad)[:4, 0]
            raise AssertionError(
                f"{label}: the LBVH's any hit disagrees with the dense "
                f"accel's, on lanes {lanes.tolist()}: origins "
                f"{so[:, lanes].T.tolist()}, directions "
                f"{sdir[:, lanes].T.tolist()}, tmax {st[lanes].tolist()}, "
                f"LBVH {hit_l[lanes].tolist()}, dense {hit_d[lanes].tolist()}")
        del sd, sl, cam, first, so, sdir, st
        means = {}
        for accel in ("dense", "lbvh"):
            sm = T.init(0, 64, 64, 0, *arrays, cam_origin=CAM_ORIGIN,
                        accel=accel, device=device)
            with timer.phase(f"render {accel}"):
                means[accel] = float(T.sample_n_frames(sm, 5).mean())
        rel = abs(means["lbvh"] - means["dense"]) / means["dense"]
        t = timer.totals
        log("lbvh", f"{label} ({arrays[0].shape[0]} triangles): build "
            f"{1e3 * t['build']:.1f} ms; closest_hit {1e3 * t['closest camera']:.1f}"
            f" ms (camera) / {1e3 * t['closest first-bounce']:.1f} ms "
            f"(first-bounce) per query of {SIZE * SIZE} rays, any_hit "
            f"{1e3 * t['any']:.1f} ms per query of {2 * SIZE * SIZE} lanes; "
            f"64x64 4-spp render mean {means['lbvh']:.5f} in "
            f"{t['render lbvh']:.3f} s, dense {means['dense']:.5f} in "
            f"{t['render dense']:.3f} s, relative difference {rel:.4f} "
            f"(limit {MEAN_REL}); CUDA events, one call each, on {card}")
        if rel > MEAN_REL:
            raise AssertionError(f"{label}: the LBVH render's mean is not "
                                 f"the dense render's")
        torch.cuda.empty_cache()


def phase_checkpoint(T, scene_arrays, device):
    """A state saved and loaded on the card resumes a step bit for bit,
    with either accel; load() puts it on the card by default."""
    import tempfile
    import torch
    from tracer_tpu_torch.engine import keys
    from tracer_tpu_torch.utils import checkpoint
    for accel in ("dense", "lbvh"):
        s = T.init(0, 64, 64, 0, *scene_arrays, cam_origin=CAM_ORIGIN,
                   accel=accel, device=device)
        s = T.step(T.step(T.key(keys.KEYDOWN, keys.SDLK_SPACE, s)))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state.npz")
            checkpoint.save(path, s)
            size = os.path.getsize(path)
            r = checkpoint.load(path)
        if r.img.device.type != "cuda" or not r.scene.tris.is_cuda:
            raise AssertionError("checkpoint.load did not load onto the card")
        if (r.nonce, r.n_frames, r.mode) != (s.nonce, s.n_frames, s.mode):
            raise AssertionError("the counters did not resume")
        a, b = T.step(s), T.step(r)
        same = torch.equal(a.img, b.img) and torch.equal(r.img, s.img)
        log("checkpoint", f"accel={accel}: {size} bytes, loaded onto "
            f"{r.img.device}; nonce {r.nonce}, n_frames {r.n_frames}; the "
            f"next step from the loaded state equals the original's bit for "
            f"bit: {same}")
        if not same:
            raise AssertionError("a loaded checkpoint did not resume the step")


# ---------------------------------------------------------------------------
# multi-device rendering, the viewer, the native host library

def held_to(phase, label, got, want, exact):
    """A sharded result against the single-process one: bit for bit when
    exact (if the card shows otherwise, within rtol 1e-5 with the
    differing pixels printed), else within rtol 1e-5."""
    import torch
    differ = torch.nonzero((got != want).flatten(0, 1).any(dim=-1))[:, 0]
    close = torch.isclose(got, want, rtol=1e-5, atol=0.0).all(dim=-1)
    log(phase, f"{label}: {'bit for bit' if exact else 'rtol 1e-5'} "
        f"against the single process; pixels differing in a bit "
        f"{differ.numel()} of {close.numel()}, within rtol 1e-5 "
        f"{int(close.sum())}")
    if exact and differ.numel():
        w = got.shape[1]
        for p in differ[:8].tolist():
            log(phase, f"{label}: pixel (row {p // w}, col {p % w}) "
                f"sharded {got[p // w, p % w].tolist()} single "
                f"{want[p // w, p % w].tolist()}")
    if not bool(close.all()):
        raise AssertionError(f"{label}: the sharded result is not the "
                             f"single process's")


def points_held_to(phase, label, got, want):
    """Sharded points against sample_points_n's: returns and positions
    equal, intensity within rtol 1e-6."""
    import torch

    def has(p):
        return ~((p[..., :3] == -1).all(-1) & (p[..., 3] == 0))
    same_has = torch.equal(has(got), has(want))
    pos_equal = (got[..., :3] == want[..., :3]).all(-1)
    inten = torch.isclose(got[..., 3], want[..., 3], rtol=1e-6, atol=0.0)
    log(phase, f"{label}: returns {int(has(got).sum())} (single "
        f"{int(has(want).sum())}), positions equal on {int(pos_equal.sum())}"
        f" of {pos_equal.numel()} pixels, intensity within rtol 1e-6 on "
        f"{int(inten.sum())}")
    if not (same_has and bool(pos_equal.all()) and bool(inten.all())):
        raise AssertionError(f"{label}: the sharded capture is not the "
                             f"single process's")


def rank_counts(phase, label, r):
    """Each rank's K1/K3 launches (> 0) and plain intersect calls (0)."""
    launches, plain = r["launches"], r["plain_calls"]
    log(phase, f"{label}: launches per rank closest_hit "
        f"{launches['closest_hit']}, any_hit {launches['any_hit']}; plain "
        f"calls per rank {plain}")
    if (min(launches["closest_hit"]) <= 0 or min(launches["any_hit"]) <= 0
            or max(max(v) for v in plain.values()) != 0):
        raise AssertionError(f"{label}: a rank did not run K1 and K3, or "
                             f"ran a plain version")


def timed(fn):
    """(fn(), seconds) on the host clock, closed by a synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_parallel(T, integrator, scene_arrays, card, device):
    """parallel/render.py on PARALLEL_RANKS gloo ranks sharing the card
    (parallel/local.run_sharded; the kernels were built by the parent
    before the spawn): the 512x512 16-spp Cornell render over (2, 2), 3
    steps over (4, 1) with the accumulation on, and the reference capture
    over (2, 2), each held to the single-process call on the same card,
    its wall beside the single call's; then NCCL at world size 1."""
    import torch
    from tracer_tpu_torch.engine import keys
    from tracer_tpu_torch.parallel import local
    tris, tm, mats = scene_arrays
    s = T.init(0, SIZE, SIZE, 0, tris, tm, mats, cam_origin=CAM_ORIGIN,
               device=device)
    sm = T.key(keys.KEYDOWN, keys.SDLK_SPACE, s)
    sl = T.init(0, LIDAR_H, LIDAR_W, 2, tris, tm, mats,
                cam_origin=CAM_ORIGIN, device=device)
    torch.cuda.empty_cache()
    n = PARALLEL_RANKS
    calls = [("render_pooled_sharded", (2, 2), s, 2),   # warm-up
             ("render_pooled_sharded", (2, 2), s, 16),
             ("step_sharded", (4, 1), sm, 3),
             ("sample_points_sharded", (2, 2), sl, LIDAR_SPP)]
    t0 = time.perf_counter()
    _, render, steps, capture = local.run_sharded(n, calls, device="cuda:0",
                                                  threads=2)
    log("parallel", f"{n} gloo ranks on {torch.cuda.get_device_name(0)}: "
        f"spawn, group, state loads and the calls "
        f"{time.perf_counter() - t0:.1f} s")
    ranks = f"{n} gloo ranks sharing one card, on {card}"

    def single_render():
        return integrator.render_pooled(
            s.seed, s.nonce, s.scene, s.cam, s.ambience, SIZE, SIZE,
            s.transmitter_kind, 16, s.render_mode)["img"]
    single_render()   # warm-up
    want, secs = timed(single_render)
    log("parallel", f"render_pooled_sharded {SIZE}x{SIZE} 16 spp over (2, 2):"
        f" {render['seconds']:.3f} s, single process {secs:.3f} s; {ranks}")
    held_to("parallel", "render (2, 2)", render["out"], want.cpu(), False)
    rank_counts("parallel", "render (2, 2)", render)

    def single_steps():
        x = sm
        for _ in range(3):
            x = T.step(x)
        return x
    want, secs = timed(single_steps)
    log("parallel", f"3 x step_sharded {SIZE}x{SIZE} over (4, 1): "
        f"{steps['seconds']:.3f} s, 3 x step {secs:.3f} s; n_frames "
        f"{steps['n_frames']} / {want.n_frames}, nonce {steps['nonce']} / "
        f"{want.nonce}; {ranks}")
    if (steps["n_frames"], steps["nonce"]) != (want.n_frames, want.nonce):
        raise AssertionError("step_sharded's counters are not step's")
    held_to("parallel", "3 steps (4, 1)", steps["out"], want.img.cpu(), True)
    rank_counts("parallel", "3 steps (4, 1)", steps)

    (_, pts), secs = timed(lambda: T.sample_points_n(sl, LIDAR_SPP))
    log("parallel", f"sample_points_sharded {LIDAR_W}x{LIDAR_H} x {LIDAR_SPP}"
        f" spp over (2, 2): {capture['seconds']:.3f} s, sample_points_n "
        f"{secs:.3f} s; {ranks}")
    points_held_to("parallel", "capture (2, 2)", capture["out"], pts.cpu())
    rank_counts("parallel", "capture (2, 2)", capture)
    del s, sm, sl
    torch.cuda.empty_cache()
    phase_nccl(T, integrator, scene_arrays, device)
    return capture["out"]


def phase_nccl(T, integrator, scene_arrays, device):
    """One NCCL group of world size 1 on the card: it initialises, reduces
    a tensor on the device, and a (1, 1) mesh renders the single image."""
    import tempfile
    import torch
    import torch.distributed as dist
    from tracer_tpu_torch.parallel import render as par
    s = T.init(0, 64, 64, 0, *scene_arrays, cam_origin=CAM_ORIGIN,
               device=device)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            x = torch.arange(4, dtype=torch.float32, device=device)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            mesh = par.make_mesh(1, 1)
            got = par.render_pooled_sharded(s, mesh, 4)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    want = integrator.render_pooled(
        s.seed, s.nonce, s.scene, s.cam, s.ambience, 64, 64,
        s.transmitter_kind, 4, s.render_mode)["img"]
    log("parallel", f"backend {backend}, world size 1: init and a first "
        f"all_reduce {init_s:.2f} s, reduced on {x.device}: {x.tolist()}; "
        f"(1, 1) mesh 64x64 4 spp equals the single render bit for bit: "
        f"{torch.equal(got, want)}")
    if (backend != "nccl" or not x.is_cuda or x.tolist() != [0, 1, 2, 3]
            or not torch.equal(got, want)):
        raise AssertionError("the NCCL group did not reduce on the card or "
                             "render the single image")


def phase_viewer(T, ik, device, card):
    """The viewer headless at the interactive cell's shape (800x600, 32
    frames) through its CLI, frames per second, K1/K3 launched and no
    plain version, its image held to the API loop's from the same
    state."""
    import numpy as np
    import torch
    from tracer_tpu_torch.frontends import interactive
    from tracer_tpu_torch.utils import image
    torch.cuda.synchronize()
    ik.reset_counts()
    state, rgb = interactive.main(["--headless", "--frames",
                                   str(VIEWER_FRAMES)])
    launches, plain = dict(ik.launches), dict(ik.plain_calls)
    log("viewer", f"launches={launches} plain_calls={plain}")
    if (launches["closest_hit"] <= 0 or launches["any_hit"] <= 0
            or max(plain.values()) != 0):
        raise AssertionError("the viewer did not run through K1 and K3")
    (tris, tm, mats), _ = load_cornell()
    s = T.init(0, VIEWER_H, VIEWER_W, 0, tris, tm, mats,
               cam_origin=CAM_ORIGIN, device=device)
    t0 = time.perf_counter()
    for _ in range(VIEWER_FRAMES):
        s = T.step(s)
    want = image.argb_to_rgb(T.render(s).cpu().numpy())
    secs = time.perf_counter() - t0
    same = bool(np.array_equal(rgb, want))
    log("viewer", f"the API loop (step, render, argb_to_rgb; no blit): "
        f"{VIEWER_FRAMES / secs:.2f} frames per second; the viewer's last "
        f"frame equals its image: {same}; on {card}")
    if not same or (state.nonce, state.n_frames) != (s.nonce, s.n_frames):
        raise AssertionError("the viewer's loop is not the API loop")


def write_obj(path, tris, tri_mats, mats):
    """An OBJ + MTL of a scene's arrays (every value in %.9g, which an
    f32 reads back exactly; the spectra as their 12 Sp/Em knots)."""
    base = os.path.splitext(path)[0]
    with open(base + ".mtl", "w") as f:
        for i, m in enumerate(mats):
            f.write(f"newmtl m{i}\nSp {' '.join(f'{v:.9g}' for v in m[:12])}"
                    f"\nPr {m[12]:.9g}\nPm {m[13]:.9g}\nNi {m[14]:.9g}\n"
                    f"Tf {m[15]:.9g}\nEm "
                    f"{' '.join(f'{v:.9g}' for v in m[16:])}\n")
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(base)}.mtl\n")
        for t in tris.reshape(-1, 3):
            f.write(f"v {t[0]:.9g} {t[1]:.9g} {t[2]:.9g}\n")
        for i, m in enumerate(tri_mats):
            f.write(f"usemtl m{m}\nf {3 * i + 1} {3 * i + 2} {3 * i + 3}\n")


def phase_native(points):
    """The native host library: its g++ build, an OBJ written from
    subdivide(cornell_like, NATIVE_LEVELS) read back natively and by the
    Python loader (equal to each other and to the arrays written), and
    the capture's points written natively and by utils/pcd.py, byte for
    byte."""
    import tempfile
    import numpy as np
    from tracer_tpu_torch.utils import native, objloader, pcd
    lib = native.load_library()
    info = native.build_info()
    log("native", f"g++ build of tracer_tpu_torch/native/objloader.cpp: "
        f"{info['seconds']:.2f} s into {info['path']}")
    if lib is None:
        raise AssertionError(f"the native library did not build: "
                             f"{info['error']}")
    arrays = cornell_sub(NATIVE_LEVELS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.obj")
        write_obj(path, *arrays)
        t0 = time.perf_counter()
        got = objloader.load_obj(path, backend="native")
        t1 = time.perf_counter()
        py = objloader.load_obj(path, backend="python")
        t2 = time.perf_counter()
        same = all(a.dtype == b.dtype and np.array_equal(a, b)
                   for x in (py, arrays) for a, b in zip(got, x))
        log("native", f"OBJ of {arrays[0].shape[0]} triangles: native "
            f"{1e3 * (t1 - t0):.1f} ms, Python {1e3 * (t2 - t1):.1f} ms; "
            f"equal to each other and to the arrays written: {same}")
        if not same:
            raise AssertionError("the native loader disagrees")
        a, b = os.path.join(tmp, "n.pcd"), os.path.join(tmp, "p.pcd")
        pts = points.numpy()
        t0 = time.perf_counter()
        native.write_pcd(a, pts)
        t1 = time.perf_counter()
        pcd.write_pcd(b, pts)
        t2 = time.perf_counter()
        with open(a, "rb") as fa, open(b, "rb") as fb:
            na, nb = fa.read(), fb.read()
        log("native", f"the sharded capture's {pts.shape[0] * pts.shape[1]}"
            f" points as PCD: native {1e3 * (t1 - t0):.1f} ms, Python "
            f"{1e3 * (t2 - t1):.1f} ms, {len(na)} bytes, byte for byte "
            f"equal: {na == nb}")
        if na != nb:
            raise AssertionError("the native PCD differs from utils/pcd's")


# ---------------------------------------------------------------------------
# the exported step

# A fresh process that imports the port's modules it names; its last
# line of output is a JSON object.
_CHILD_HEAD = """
import json, sys, time
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
device = torch.device({device!r})
sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
"""

# Export one state's step: load its checkpoint on the card, export_step,
# write the artifact.
_EXPORT_CHILD = _CHILD_HEAD + """
from tracer_tpu_torch.utils import aot, checkpoint
state = checkpoint.load({ck!r}, device=device)
t0 = time.perf_counter()
blob = aot.export_step(state)
secs = time.perf_counter() - t0
with open({art!r}, "wb") as f:
    f.write(blob)
print(json.dumps({{"export_s": secs, "bytes": len(blob)}}))
"""

# Step every state from its checkpoint and artifact, AOT_STEPS times, in
# one process that never builds a scene or imports the integrator.
_STEP_CHILD = _CHILD_HEAD + """
from tracer_tpu_torch.ops import intersect_kernel as ik
from tracer_tpu_torch.utils import aot, checkpoint
out = {{}}
for name, ck, art, res in {cases!r}:
    t0 = time.perf_counter()
    state = checkpoint.load(ck, device=device)
    t1 = time.perf_counter()
    step = aot.load_step(art)
    t2 = time.perf_counter()
    ik.reset_counts()
    walls, imgs, counters = [], [], []
    for _ in range({steps}):
        sync()
        t = time.perf_counter()
        state = step(state)
        sync()
        walls.append(time.perf_counter() - t)
        imgs.append(state.img.cpu().numpy())
        counters.append([state.n_frames, state.nonce])
    np.savez(res, imgs=np.stack(imgs), counters=np.asarray(counters))
    out[name] = {{"checkpoint_s": t1 - t0, "load_s": t2 - t1,
                  "walls": walls, "launches": dict(ik.launches),
                  "plain_calls": dict(ik.plain_calls),
                  "device": str(state.img.device)}}
out["modules"] = sorted(m for m in sys.modules
                        if m.startswith("tracer_tpu_torch.engine"))
out["integrator"] = "tracer_tpu_torch.engine.integrator" in sys.modules
out["jax"] = "jax" in sys.modules or "tracer_tpu" in sys.modules
print(json.dumps(out))
"""


def run_child(code, timeout):
    """A fresh python process on `code`: (the JSON of its last line,
    seconds). Its output is printed when it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
        raise AssertionError(f"a child process failed ({proc.returncode})")
    return json.loads(proc.stdout.strip().splitlines()[-1]), secs


def aot_states(T, scene_arrays, device):
    """The states of phase aot, each with the accumulation on and one
    frame taken: name -> (state, the kernels its step must launch)."""
    from dataclasses import replace
    sub6 = cornell_sub(SLICE_LEVELS)
    cases = {
        "cornell-512": (SIZE, SIZE, 0, scene_arrays, "auto",
                        ("closest_hit", "any_hit")),
        "cornell-sub6-512": (SIZE, SIZE, 0, sub6, "auto",
                             ("closest_hit_streamed", "any_hit_streamed")),
        "capture-640x480": (LIDAR_W, LIDAR_H, 2, scene_arrays, "auto",
                            ("closest_hit", "any_hit")),
        "lbvh-128": (AOT_LBVH_SIZE, AOT_LBVH_SIZE, 0, scene_arrays, "lbvh",
                     ()),
    }
    out = {}
    for name, (w, h, conf, arrays, accel, kernels) in cases.items():
        s = T.init(0, h, w, conf, *arrays, cam_origin=CAM_ORIGIN,
                   accel=accel, device=device)
        out[name] = (T.step(replace(s, mode=True)), kernels)
    return out


class AotExports:
    """Phase aot's first half, started while checks that time nothing
    run: the states, their checkpoints in a temporary directory, and one
    process per state that exports its step (utils/aot.export_step) at
    the lowest priority. wait() collects them; close() (also at exit)
    stops any still running and removes the directory."""

    def __init__(self, T, scene_arrays, device):
        import atexit
        import tempfile
        from tracer_tpu_torch.utils import checkpoint
        self.device = device
        self.states = aot_states(T, scene_arrays, device)
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_aot_")
        self.procs = {}
        atexit.register(self.close)
        self.paths = {name: tuple(os.path.join(self.tmp, f"{name}.{ext}")
                                  for ext in ("npz", "pt2", "res.npz"))
                      for name in self.states}
        for name, (s, _) in self.states.items():
            checkpoint.save(self.paths[name][0], s)
        root = os.path.dirname(os.path.abspath(__file__))
        self.t0 = time.perf_counter()
        for name in self.states:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-c", _EXPORT_CHILD.format(
                    root=root, device=str(device), ck=self.paths[name][0],
                    art=self.paths[name][1])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                preexec_fn=lambda: os.nice(19))
        log("aot", f"4 export processes started at "
            f"{self.t0 - _T0:.1f} s, beside checks that time nothing")
        self.exports = None

    def wait(self):
        """name -> {"export_s", "bytes"}, once every export has ended."""
        if self.exports is None:
            self.exports = {}
            for name, proc in self.procs.items():
                out, err = proc.communicate(timeout=AOT_TIMEOUT)
                if proc.returncode != 0:
                    print(out[-4000:], err[-8000:], file=sys.stderr)
                    raise AssertionError(f"exporting the step of {name} "
                                         f"failed")
                self.exports[name] = json.loads(out.strip().splitlines()[-1])
            secs = time.perf_counter() - self.t0
            log("aot", f"the 4 exports ended {secs:.1f} s after they "
                f"started")
        return self.exports

    def close(self):
        import shutil
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def phase_aot(T, aot, card):
    """The exported step (utils/aot.py) on the four states of aot (an
    AotExports): AOT_STEPS api.step calls from each state, timed, in this
    process; the exports collected; then one fresh process that loads
    each state from its checkpoint and its artifact and steps it
    AOT_STEPS times, never importing the integrator. Its images and
    counters are held bit for bit to the api.step calls; each state's
    kernels launched from the exported step, no plain version."""
    import numpy as np
    root = os.path.dirname(os.path.abspath(__file__))
    eager = {}
    for name, (s, _) in aot.states.items():
        walls, imgs, counters = [], [], []
        for _ in range(AOT_STEPS):
            s, secs = timed(lambda s=s: T.step(s))
            walls.append(secs)
            imgs.append(s.img.cpu().numpy())
            counters.append([s.n_frames, s.nonce])
        eager[name] = (walls, np.stack(imgs), np.asarray(counters))
    exports = aot.wait()
    clock("aot eager")
    paths = aot.paths
    cases = [(name, *paths[name]) for name in aot.states]
    res, secs = run_child(_STEP_CHILD.format(
        root=root, device=str(aot.device), cases=cases, steps=AOT_STEPS),
        AOT_TIMEOUT)
    log("aot", f"the stepping process: {secs:.1f} s from its start to "
        f"its end; engine modules it imported: {res['modules']}; "
        f"engine.integrator imported: {res['integrator']}; jax or "
        f"tracer_tpu imported: {res['jax']}")
    if res["integrator"] or res["jax"]:
        raise AssertionError("the stepping process imported the "
                             "integrator or the JAX package")
    for name, (s, kernels) in aot.states.items():
        got = np.load(paths[name][2])
        walls, imgs, counters = eager[name]
        r, e = res[name], exports[name]
        same = (np.array_equal(got["imgs"], imgs)
                and np.array_equal(got["counters"], counters))
        launched = {k: v for k, v in r["launches"].items() if v}
        log("aot", f"{name}: export {e['export_s']:.2f} s, "
            f"{e['bytes']:,} bytes; checkpoint load "
            f"{r['checkpoint_s']:.2f} s, artifact load "
            f"{r['load_s']:.2f} s; exported step walls "
            f"{[round(w, 4) for w in r['walls']]} s against eager "
            f"api.step {[round(w, 4) for w in walls]} s; launches "
            f"{launched}, plain calls {sum(r['plain_calls'].values())}; "
            f"n_frames, nonce {got['counters'].tolist()}; images and "
            f"counters equal bit for bit: {same}; on {r['device']}, "
            f"{card}")
        if not same:
            raise AssertionError(f"{name}: the exported step differs "
                                 f"from api.step")
        if not np.isfinite(imgs).all() or imgs[-1].max() <= 0:
            raise AssertionError(f"{name}: the image is not finite "
                                 f"or black")
        if (any(r["launches"][k] <= 0 for k in kernels)
                or sum(r["plain_calls"].values())
                or set(launched) - set(kernels)):
            raise AssertionError(f"{name}: the exported step did not "
                                 f"run on the kernels {kernels} alone")
    aot.close()


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
    clock("kernels")
    del s
    s, launches, cornell_mean = phase_main(T, integrator, ik, scene_arrays,
                                           card, device)
    phase_reference(T, scene_arrays, device)
    clock("main")
    pool_times = phase_breakdown(
        integrator, ik, s, card, ("closest_hit", "any_hit"), errs, "Cornell",
        one_chunk=True)
    clock("breakdown")
    del s
    torch.cuda.empty_cache()
    shade_times = phase_shade(T, integrator, scene_arrays, card, device)
    clock("shade")
    # phase aot's exports run beside the checks that time nothing: the
    # big-scene checks and the checkpoint phase
    aot = []

    def beside_exports():
        phase_checkpoint(T, scene_arrays, device)
        clock("checkpoint")
        aot[0].wait()

    big_launches, times, big_pool = phase_bigscene(
        T, integrator, ik, intersect, card, device, errs, cornell_mean,
        before_checks=lambda: aot.append(AotExports(T, scene_arrays, device)),
        after_checks=beside_exports)
    pool_times.update(big_pool)
    clock("bigscene")
    launches.update({k: big_launches[k] for k in
                     ("closest_hit_streamed", "any_hit_streamed")})
    torch.cuda.empty_cache()
    k5 = phase_recip(device, card)
    clock("recip")
    torch.cuda.empty_cache()
    lidar_launches, capture_k1, capture_pool = phase_lidar(
        T, integrator, ik, scene_arrays, card, device, errs)
    log("lidar", f"capture launches {lidar_launches}")
    clock("lidar")
    torch.cuda.empty_cache()
    phase_lbvh(T, integrator, intersect, scene_arrays, card, device)
    clock("lbvh")
    points = phase_parallel(T, integrator, scene_arrays, card, device)
    clock("parallel")
    phase_viewer(T, ik, device, card)
    clock("viewer")
    phase_native(points)
    clock("native")
    phase_aot(T, aot[0], card)
    clock("aot")
    cornell["closest_hit"].update(
        {f"capture_{f}": v for f, v in capture_k1.items()})
    for k, t in capture_pool.items():
        cornell[k].update({f"capture_pool_{f}": v for f, v in t.items()})

    fields = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "timed_at", "host_us",
              "library_host_us", "graph_ms", "library_graph_ms")
    # ms, alone_ms, plain_ms and bound_ms of K1-K4: on a query of the
    # pool, the shapes the main path gives the kernel (K1/K3 the Cornell
    # render's, K2/K4 cornell-sub6's); frame_*, cornell_*, capture_*: the
    # per-frame shapes of render_frames, where the kernels' history was
    # measured. The yardstick is not on the path and keeps the latter.
    kernels = [{"name": f"{k}_kernel", "route": "cuda",
                "source": "tracer_tpu_torch/csrc/intersect.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": errs[k],
                **(times[k] if k == EXACT else
                   {**pool_times[k],
                    **{f"frame_{f}": v for f, v in times[k].items()}}),
                **{f"cornell_{f}": v for f, v in cornell.get(k, {}).items()}}
               for k in VARIANTS + (EXACT,)]
    # the exact kernel is a check, not a kernel of the path: its one
    # launch in the main path's window is the smoke run's own
    kernels[-1]["on_path"] = False
    kernels.append({"name": "approx_reciprocal_kernel", "route": "cuda",
                    "source": "tracer_tpu_torch/csrc/recip.cu",
                    "replaces": "benchmarks/measure_recip.py:30",
                    **{k: k5[k] for k in fields}})
    # K6 and K7: launches of the main path's window, the rest at the
    # operands of its pool (capture_*: the capture's)
    kernels += [{"name": f"{k}_kernel", "route": "cuda",
                 "source": "tracer_tpu_torch/csrc/shade.cu",
                 "replaces": REPLACES[k], "launches": launches[k],
                 **shade_times[k]} for k in SHADE_KERNELS]
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
