"""The SPD tetra scene (scenes/spd_tetra.py) and its configuration: the
generator's counts, points, winding and placement; the size factor of
the generator and of the file agree; the scene reaches the port's
streamed queries; and the cell's render, at size factor 4 and a small
image on the CPU, is correct against the plain reference."""

import itertools
import json
import shutil
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench import run as bench_run
from portbench.scenes import spd_tetra as S

BENCH = harness.manifest()
CELL = "spd-tetra.render-16spp"
CONFIG = harness.load_json(harness.HERE / "configs" / "spd-tetra.json")


def _key(p):
    return tuple(np.round(np.asarray(p, np.float64), 12))


@pytest.mark.parametrize("sf", range(5))
def test_counts(sf):
    assert S.leaves(sf).shape == (4 ** sf, 4, 3)
    assert S.faces(sf).shape == (4 ** (sf + 1), 3, 3)
    tris, tm, mats = S.build(sf)
    assert tris.shape == (4 ** (sf + 1) + 2, 3, 3) and tris.dtype == np.float32
    assert tm.tolist() == [0] * 4 ** (sf + 1) + [1, 1]
    assert mats.shape == (2, 28)


def test_size_factor_zero_is_the_roots_four_faces():
    got = sorted(sorted(_key(v) for v in f) for f in S.faces(0))
    want = sorted(sorted(_key(v) for v in c)
                  for c in itertools.combinations(S.ROOT, 3))
    assert got == want


def test_vertices_are_the_closed_form_sierpinski_points():
    """At size factor 2 every vertex is sum_k v[c_k] / 2^k + v[j] / 4
    over the corner paths c in {0..3}^2 and j, and every such point is
    a vertex."""
    sf = 2
    want = {_key(sum(S.ROOT[c] / 2.0 ** (k + 1) for k, c in enumerate(path))
                 + S.ROOT[j] / 2.0 ** sf)
            for path in itertools.product(range(4), repeat=sf)
            for j in range(4)}
    got = {_key(v) for v in S.faces(sf).reshape(-1, 3)}
    assert got == want


def test_faces_are_wound_outward_and_none_is_degenerate():
    tris = S.build(3)[0][:-2].astype(np.float64)
    leaf_centers = tris.reshape(-1, 4 * 3, 3).mean(axis=1)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    area = 0.5 * np.linalg.norm(n, axis=1)
    assert area.min() > 0.9 * area.max() > 0
    out = tris.mean(axis=1) - np.repeat(leaf_centers, 4, axis=0)
    assert ((n * out).sum(axis=1) > 0).all()


def test_placement_and_light():
    """The centroid on the camera's axis CAMERA_DISTANCE ahead; no face
    edge-on and no symmetry axis within 15 degrees of the axis there;
    the light's normal faces the centroid, and it lies beyond the
    pyramid on every axis (so the Morton order puts it last)."""
    tris = S.build(2)[0].astype(np.float64)
    pyramid, light = tris[:-2], tris[-2:]
    center = pyramid.reshape(-1, 3).mean(axis=0)
    assert np.allclose(center, [0.0, 0.0, S.CAMERA_ORIGIN[2]
                                - S.CAMERA_DISTANCE], atol=1e-6)
    r = S.rotation()
    axis = np.array([0.0, 0.0, 1.0])
    three = S.ROOT / np.sqrt(3.0) @ r.T
    normals_deg = np.degrees(np.arcsin(np.abs(three @ axis)))
    axes = np.vstack([three, r.T])          # 3-fold and 2-fold axes
    off_deg = np.degrees(np.arccos(np.abs(axes @ axis)))
    assert normals_deg.min() > 15 and off_deg.min() > 15
    n = np.cross(light[:, 1] - light[:, 0], light[:, 2] - light[:, 0])
    assert ((n * (center - light.mean(axis=1))).sum(axis=1) > 0).all()
    assert (light.mean(axis=1).min(axis=0)
            > pyramid.mean(axis=1).max(axis=0)).all()


def test_file_and_generator_agree():
    assert S.SIZE_FACTOR == CONFIG["size_factor"] == 8
    assert CONFIG["triangles"] == 4 ** (S.SIZE_FACTOR + 1) + 2 == 262_146
    assert tuple(CONFIG["camera"]["origin"]) == S.CAMERA_ORIGIN
    assert CONFIG["scene"] == {"generator": "spd_tetra"}
    entry = {c["name"]: c for c in BENCH["configs"]}["spd-tetra"]
    assert entry["reduced"] == [] and "size factor 8" in entry["source"]
    for key in ("size_factor", "placement", "camera", "color", "light",
                "background"):
        assert CONFIG["assumed"][key]


def test_scene_takes_the_streamed_queries():
    """The port's own arithmetic on the scene as api.init builds it
    (build_scene, the dense accel): 262,400 padded triangles in 1,025
    chunks of 256, the streamed variants, g = 17 over 61 superchunks,
    the ray sort on a card, the streamed pool's lanes."""
    from tracer_tpu_torch.engine import integrator
    from tracer_tpu_torch.models import scene as scene_mod
    from tracer_tpu_torch.ops import intersect
    from tracer_tpu_torch.ops import intersect_kernel as ik
    tris, tm, mats = S.build()
    sc = scene_mod.build_scene(tris, tm, mats, accel=CONFIG["accel"],
                               device="cpu")
    dense = sc.accel
    assert isinstance(dense, intersect.DenseTris)
    n_chunks, t_pad = dense.chunk_bounds.shape[0], dense.coeffs.shape[1]
    assert (n_chunks, t_pad) == (1025, 262_400)
    assert ik.streamed_variant(t_pad)
    assert [ik.variant_name(q, ik.streamed_variant(t_pad))
            for q in ("closest", "any")] == ["closest_hit_streamed",
                                             "any_hit_streamed"]
    # the light's two triangles close the Morton order, alone in a chunk
    assert sorted(dense.perm[1024 * 256:1024 * 256 + 2].tolist()) == [
        262_144, 262_145]
    phi = torch.zeros((10, 300))
    phi[2] = -1.0
    phi[5] = S.CAMERA_ORIGIN[2]
    g, sbounds, order, count = ik.walk_schedule(phi, 10.0,
                                                dense.chunk_bounds)
    assert (g, sbounds.shape[0]) == (17, 61)
    assert order.shape == (2, 61) and count.shape == (2,)
    assert intersect.resolve_perm("auto", n_chunks, "cuda") == "odmorton"
    assert intersect.resolve_perm("auto", n_chunks, "cuda",
                                  any_hit=True) == "odmorton"
    mix = harness.load_json(harness.HERE / "traffic" / "render-16spp.json")
    n = mix["width"] * mix["height"]
    assert integrator._pool_size(n, mix["spp"], t_pad) == \
        integrator.POOL_LANES_STREAMED == 524_288


def test_cell_is_correct_at_size_factor_4(tmp_path):
    """The cell through a copy of the benchmark whose generator is at
    size factor 4 (1,026 triangles), at 16x16 and 2 spp on the CPU:
    correct under the cell's own limits."""
    base = tmp_path / "portbench"
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    gen = base / "scenes" / "spd_tetra.py"
    src = gen.read_text()
    assert "\nSIZE_FACTOR = 8\n" in src
    gen.write_text(src.replace("\nSIZE_FACTOR = 8\n", "\nSIZE_FACTOR = 4\n"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    cell = harness.Cell(harness.manifest(tmp_path), CELL, base)
    mix = dict(cell.traffic, width=16, height=16, spp=2)
    r = bench_run.run_cell(cell, 3_141_592_653, 0.0, False, "cpu",
                           time.perf_counter(), mix=mix)
    assert r["correct"], r["checks"]
    assert r["checks"]["gap_p90"]["limit"] == 1e-4
    assert r["checks"]["off_share"]["limit"] == 0.03
    assert set(r["metrics"]) == {"setup_s", "msamples_per_s"}


@pytest.mark.requires_cuda
def test_queries_stream_and_sort_on_the_card(cuda):
    """On the card, a small render of the full scene through the API:
    every query lane goes to K2/K4 (query.lanes.*) and none to K1/K3,
    the closest lanes are the pool's lane-iterations, and each query
    sorts its lanes (query.sort)."""
    from tracer_tpu_torch.engine import api
    from tracer_tpu_torch.utils import profiling
    tris, tm, mats = S.build()
    s = api.init(5, 64, 64, 0, tris, tm, mats, cam_origin=S.CAMERA_ORIGIN,
                 accel=CONFIG["accel"], device=cuda)
    profiling.reset()
    try:
        with profiling.tracing():
            img = api.sample_n_frames(s, 4)
            torch.cuda.synchronize()
        c, summ = profiling.counters(), profiling.summary()
    finally:
        profiling.reset()
    lanes = {k: v for k, v in c.items() if k.startswith("query.lanes.")}
    assert set(lanes) == {"query.lanes.closest_hit_streamed",
                          "query.lanes.any_hit_streamed"}
    assert lanes["query.lanes.closest_hit_streamed"] == c["pool.lane_iters"]
    assert summ["query.sort"]["count"] == 2 * c["pool.iters"]
    assert float((img.amax(dim=-1) > 0).float().mean()) > 0.05
