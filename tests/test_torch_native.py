"""Port parity: the native host library (tracer_tpu_torch/native,
utils/native.py) against the port's Python loader and PCD writer and
against the JAX package's native library, on the tiny OBJ/MTL scene of
tests/test_loader.py."""

import numpy as np
import pytest

from tracer_tpu.utils import native as jnative
from tracer_tpu_torch.utils import native
from tracer_tpu_torch.utils import objloader as tobj
from tracer_tpu_torch.utils import pcd

MTL = """
newmtl red
  Kd 0.8 0.1 0.2
  Ni 1.4
  Pr 0.3
  Pm 0.6
  Tf 0.5
newmtl glow
  Kd 0 0 0
  Ke 2 3 4
newmtl spectral
  Sp 500 1.0 600 0.5
  Em 450 2.0
"""

OBJ = """
mtllib s.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
usemtl red
f 1 2 3 4
usemtl glow
f -4 -3 -2
usemtl spectral
f 1 2 4
"""


@pytest.fixture
def tiny_scene(tmp_path):
    (tmp_path / "s.mtl").write_text(MTL)
    (tmp_path / "s.obj").write_text(OBJ)
    return str(tmp_path / "s.obj")


@pytest.fixture
def failing_build(tmp_path, monkeypatch):
    """A compiler that fails, into an empty build directory; the cached
    load is dropped before and after."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", "false")
    native._load.cache_clear()
    yield
    native._load.cache_clear()


def _assert_same(got, want):
    assert len(got) == len(want) == 3
    for t, j in zip(got, want):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)


def test_native_builds_at_first_use():
    assert native.available()
    info = native.build_info()
    assert info["error"] is None and info["seconds"] >= 0.0
    assert info["path"] == str(native.library_path())
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().name.startswith("libtracerhost-")


@pytest.mark.parametrize("backend", ["auto", "native"])
def test_loader_matches_python_and_jax_native(backend, tiny_scene):
    got = tobj.load_obj(tiny_scene, backend=backend)
    _assert_same(got, tobj.load_obj(tiny_scene, backend="python"))
    assert got[0].shape == (4, 3, 3) and got[1].tolist() == [0, 0, 1, 2]
    if not jnative.available():
        pytest.skip("the JAX package's native library does not build here")
    _assert_same(got, jnative.load_obj(tiny_scene))


def test_native_refuses_a_bad_file(tiny_scene, tmp_path):
    bad = tmp_path / "bad.obj"
    bad.write_text("mtllib s.mtl\nv 0 0 0\nusemtl nothing\n")
    with pytest.raises(RuntimeError, match="unknown material"):
        native.load_obj(str(bad))
    with pytest.raises(RuntimeError, match="cannot open"):
        native.load_obj(str(tmp_path / "missing.obj"))
    # "auto" has the Python loader name the fault, as the JAX twin does
    with pytest.raises(ValueError, match="unknown material"):
        tobj.load_obj(str(bad))
    with pytest.raises(ValueError, match="backend"):
        tobj.load_obj(tiny_scene, backend="rust")


def test_native_pcd_equals_python_writer(tmp_path):
    r = np.random.default_rng(0)
    pts = (r.standard_normal((12, 10, 4)) * 3).astype(np.float32)
    pts[::3, ::2] = [-1.0, -1.0, -1.0, 0.0]   # pixels without a return
    pts[1, 1] = [1e-8, -0.0, 123456.7, 1e30]
    native.write_pcd(str(tmp_path / "n.pcd"), pts)
    pcd.write_pcd(str(tmp_path / "p.pcd"), pts)
    got = (tmp_path / "n.pcd").read_bytes()
    assert got == (tmp_path / "p.pcd").read_bytes()
    assert b"POINTS 120\n" in got
    with pytest.raises(RuntimeError, match="cannot open"):
        native.write_pcd(str(tmp_path / "no" / "dir.pcd"), pts)


def test_native_backend_raises_when_the_build_fails(failing_build,
                                                    tiny_scene):
    assert native.load_library(build=False) is None
    assert not native.available()
    assert "false failed" in native.build_info()["error"]
    with pytest.raises(RuntimeError, match="native library unavailable"):
        tobj.load_obj(tiny_scene, backend="native")
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.write_pcd("unused.pcd", np.zeros((1, 4), np.float32))
    # "auto" takes the Python loader
    _assert_same(tobj.load_obj(tiny_scene),
                 tobj.load_obj(tiny_scene, backend="python"))
