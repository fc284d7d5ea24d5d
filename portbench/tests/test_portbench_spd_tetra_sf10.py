"""SPD tetra at size factor 10 (scenes/spd_tetra_sf10.py) and its
configuration, spd-tetra-sf10-lbvh: every face clears the ray-triangle
test's TRI_EPS tenfold (one leaf's four faces: all leaves are congruent),
the generator and the file agree, the scene lies past the port's dense
cap; the LBVH rooflines (yardstick/lbvh.py) on stub runs, with their
None cases; the two cells of this configuration's PR found by name; the
cell's render through the LBVH, at size factor 3 and a small image on
the CPU, correct under its own limits."""

import json
import shutil
import time

import numpy as np
import pytest

from portbench import drive, harness
from portbench import run as bench_run
from portbench.reference.intersect import TRI_EPS
from portbench.scenes import spd_tetra
from portbench.scenes import spd_tetra_sf10 as S
from portbench.yardstick import lbvh, roofline

BENCH = harness.manifest()
CELL = "spd-tetra-sf10-lbvh.render-16spp"
BOX_CELL = "cornell-box.render-16spp"
CONFIG = harness.load_json(harness.HERE / "configs"
                           / "spd-tetra-sf10-lbvh.json")
CARD = "NVIDIA H100 80GB HBM3"


def _first_leaf_faces(size_factor):
    """The four faces of leaf 0 (the corner-0 child, size_factor times)
    in the root's frame: the root's faces scaled by 2^-size_factor about
    corner 0."""
    k = 2.0 ** -size_factor
    return spd_tetra.faces(0) * k + spd_tetra.ROOT[0] * (1.0 - k)


def _cross_norm(tris):
    t = np.asarray(tris, np.float64)
    return np.linalg.norm(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]),
                          axis=1)


def test_first_leaf_is_the_generators():
    np.testing.assert_allclose(spd_tetra.faces(3)[:4], _first_leaf_faces(3),
                               atol=1e-12)
    np.testing.assert_array_equal(S.build(3)[0][:4],
                                  S.place(_first_leaf_faces(3))
                                  .astype(np.float32))


def test_every_face_clears_tri_eps_tenfold():
    """At size factor 10 a face's |e1 x e2|, its |a| seen head on, is
    over 10 x TRI_EPS on the f32 vertices the generator writes; at scale
    1 it would be below TRI_EPS, invisible to every ray."""
    leaf = S.place(_first_leaf_faces(S.SIZE_FACTOR)).astype(np.float32)
    assert (_cross_norm(leaf) >= 10 * TRI_EPS).all(), _cross_norm(leaf)
    assert (_cross_norm(_first_leaf_faces(S.SIZE_FACTOR)) < TRI_EPS).all()
    # each face is a size-factor-8 face of spd-tetra, up to rounding
    sf8 = (_first_leaf_faces(8) @ spd_tetra.rotation().T
           + spd_tetra.centroid()).astype(np.float32)
    np.testing.assert_allclose(_cross_norm(leaf), _cross_norm(sf8),
                               rtol=1e-3)


@pytest.mark.parametrize("sf", [0, 2])
def test_counts_and_placement(sf):
    tris, tm, mats = S.build(sf)
    assert tris.shape == (4 ** (sf + 1) + 2, 3, 3) and tris.dtype == np.float32
    assert tm.tolist() == [0] * 4 ** (sf + 1) + [1, 1]
    assert mats.shape == (2, 28)
    pyramid, light = tris[:-2].astype(np.float64), tris[-2:]
    assert np.allclose(pyramid.reshape(-1, 3).mean(axis=0), S.centroid(),
                       atol=1e-5)
    n = np.cross(light[:, 1] - light[:, 0], light[:, 2] - light[:, 0])
    assert ((n * (S.centroid() - light.mean(axis=1))).sum(axis=1) > 0).all()
    np.testing.assert_allclose(_cross_norm(light).sum() / 2,
                               S.LIGHT_SIDE ** 2, rtol=1e-5)


def test_file_and_generator_agree():
    from tracer_tpu_torch.models import scene as scene_mod
    assert S.SIZE_FACTOR == CONFIG["size_factor"] == 10
    assert CONFIG["triangles"] == 4 ** (S.SIZE_FACTOR + 1) + 2 == 4_194_306
    assert CONFIG["triangles"] > scene_mod.DENSE_THRESHOLD
    assert tuple(CONFIG["camera"]["origin"]) == S.CAMERA_ORIGIN
    assert S.CAMERA_ORIGIN[2] == S.SCALE * spd_tetra.CAMERA_ORIGIN[2]
    assert CONFIG["scene"] == {"generator": "spd_tetra_sf10"}
    assert CONFIG["accel"] == "auto"
    entry = {c["name"]: c for c in BENCH["configs"]}["spd-tetra-sf10-lbvh"]
    assert entry["reduced"] == [] and "size factor 10" in entry["source"]
    for key in ("size_factor", "scale", "placement", "camera", "color",
                "light", "background", "accel"):
        assert CONFIG["assumed"][key]


def test_cells_are_found_by_name():
    """Both cells resolve their configuration, traffic, check and every
    metric's reader by name; the LBVH rooflines are the new cell's alone,
    the dense rooflines the box's."""
    for name, config in ((CELL, "spd-tetra-sf10-lbvh"),
                         (BOX_CELL, "cornell-box")):
        cell = harness.Cell(BENCH, name)
        assert cell.chips == 1 and cell.entry["config"] == config
        assert cell.traffic["entry"] == "sample_n_frames"
        assert cell.traffic["spp"] == 16
        assert cell.check["limits"] == {"gap_p90": 1e-4, "off_share": 0.03}
        assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                        "msamples_per_s"]
        for m in cell.per_layer + cell.end_to_end:
            assert callable(harness.reader(m["name"]))
        layer = {m["name"] for m in cell.per_layer}
        assert {"device.busy_pct.offline", "pool.ms_per_iter.offline",
                "bounce.device_ops_per_iter", "pool.live_pct.offline",
                "host.wait_pct.offline"} <= layer
        lbvh_metrics = {"lbvh_closest_roofline", "lbvh_any_roofline"}
        dense = {"closest_hit_roofline", "any_hit_roofline"}
        assert (layer & lbvh_metrics) == (lbvh_metrics if name == CELL
                                          else set())
        assert (layer & dense) == (set() if name == CELL else dense)


def _stub_run(counters=True, card=CARD, ops=None, iters=3):
    """An offline Run whose traced stretch the program's recorder holds:
    iters pool iterations, and (counters) the walks' lanes and the tree's
    triangles."""
    from tracer_tpu_torch.utils import profiling
    run = drive.Run("sample_n_frames", "offline", 4, 4, 1, 16)
    run.card = card
    run.trace = {"iters": iters, "breakdown": {"device_ops": ops if ops
                                               is not None else [
        ["(anonymous namespace)::lbvh_closest_kernel((anonymous "
         "namespace)::LbvhArgs, long long*, float*)", 0.002],
        ["void at::native::elementwise_kernel<128, 4>", 0.5],
        ["(anonymous namespace)::lbvh_any_kernel((anonymous "
         "namespace)::LbvhArgs, bool*)", 0.001]]}}
    profiling.reset()
    with profiling.tracing():
        profiling.count("pool.iters", iters)
        if counters:
            for q in ("closest", "any"):
                name = lbvh.COUNTER_NAMES[q]
                for _ in range(iters):
                    profiling.count("query.lanes." + name, 1000)
                    profiling.count("query.tris." + name, 100_000)
    return run


@pytest.fixture
def recorder():
    from tracer_tpu_torch.utils import profiling
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("query,answer", [("closest", 8), ("any", 1)])
def test_roofline_on_a_stub_run(query, answer, recorder):
    """bound: 36 B a triangle of every launch and (4 + answer) B a lane,
    over the card's memory rate; spent: the kernel's device ops of the
    breakdown; the share 100 x bound / spent."""
    run = _stub_run()
    moved = 3 * (roofline.TRI_BYTES * 100_000 + (4 + answer) * 1000)
    bound = moved / roofline.peaks(CARD)["hbm_bytes_per_s"]
    spent = 0.002 if query == "closest" else 0.001
    assert lbvh.bound_s(run, query) == pytest.approx(bound)
    assert lbvh.spent_s(run, query) == spent
    got = harness.reader(f"lbvh_{query}_roofline")(run)
    assert got == pytest.approx(100.0 * bound / spent)
    assert 0 < got < 100


@pytest.mark.parametrize("metric", ["lbvh_closest_roofline",
                                    "lbvh_any_roofline"])
def test_roofline_reads_nothing_where_nothing_is_there(metric, recorder):
    """None on an untraced run, on a program that counts no walk (the
    dense path, or the parent's program), on a breakdown without the
    kernel, on a card without peaks, and on a recorder of another
    stretch."""
    read = harness.reader(metric)
    run = _stub_run()
    assert read(run) is not None
    untraced = drive.Run("sample_n_frames", "offline", 4, 4, 1, 16)
    untraced.card = CARD
    assert read(untraced) is None
    assert read(_stub_run(counters=False)) is None
    assert read(_stub_run(ops=[["closest_hit_kernel", 0.1]])) is None
    assert read(_stub_run(card="Some Other Card")) is None
    other = _stub_run()
    other.trace["iters"] = 4
    assert read(other) is None


def test_cell_is_correct_through_the_lbvh_at_size_factor_3(tmp_path,
                                                           monkeypatch):
    """The cell through a copy of the benchmark whose generator is at
    size factor 3 (258 triangles), with the dense cap below it so that
    "auto" builds the LBVH as at full size, at 16x16 and 2 spp on the
    CPU: the LBVH is built, and the render is correct under the cell's
    own limits."""
    from tracer_tpu_torch.models import scene as scene_mod
    from tracer_tpu_torch.ops import bvh
    base = tmp_path / "portbench"
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    gen = base / "scenes" / "spd_tetra_sf10.py"
    src = gen.read_text()
    assert "\nSIZE_FACTOR = 10\n" in src
    gen.write_text(src.replace("\nSIZE_FACTOR = 10\n", "\nSIZE_FACTOR = 3\n"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    monkeypatch.setattr(scene_mod, "DENSE_THRESHOLD", 100)
    built = []
    monkeypatch.setattr(bvh, "build",
                        lambda tris, f=bvh.build: built.append(1) or f(tris))
    cell = harness.Cell(harness.manifest(tmp_path), CELL, base)
    mix = dict(cell.traffic, width=16, height=16, spp=2)
    r = bench_run.run_cell(cell, 2_971_215_073, 0.0, False, "cpu",
                           time.perf_counter(), mix=mix)
    assert built
    assert r["correct"], r["checks"]
    assert r["checks"]["gap_p90"]["limit"] == 1e-4
    assert r["checks"]["off_share"]["limit"] == 0.03
    assert set(r["metrics"]) == {"setup_s", "msamples_per_s"}
