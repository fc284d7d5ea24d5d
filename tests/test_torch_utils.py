"""Port parity: the host-side modules the port keeps of its own (the OBJ
loader, the procedural Cornell box, the SDL key codes) give what the JAX
package's originals give; and no source of the port, nor chip_smoke.py,
imports jax or the JAX package."""

import ast
import pathlib

import numpy as np
import pytest

from tracer_tpu.engine import keys as jkeys
from tracer_tpu.utils import objloader as jobj
from tracer_tpu.utils import testscenes as jscenes
from tracer_tpu_torch.engine import keys as tkeys
from tracer_tpu_torch.utils import kernel_cases as tkc
from tracer_tpu_torch.utils import objloader as tobj
from tracer_tpu_torch.utils import testscenes as tscenes

ROOT = pathlib.Path(__file__).resolve().parents[1]

MTL = """# two materials, one spectral
newmtl white
Kd 0.73 0.71 0.68
newmtl glass
Sp 400 0.2 550 0.9 700 0.4
Em 450 3.0 650 1.0
Ni 1.5
Pr 0.1
Pm 0.25
Tf 0.0
"""

OBJS = {
    "quads": """mtllib m.mtl
v -1 0 -1
v 1 0 -1
v 1 2 -1
v -1 2 -1
v 0 1 0
usemtl white
f 1 2 3 4
usemtl glass
f 1/1/1 2/2/2 5/5/5
f -5 -4 -1
""",
    "pentagon": """mtllib m.mtl
v 0 0 0
v 1 0 0
v 1.3 1 0
v 0.5 1.6 0
v -0.3 1 0  # comment
usemtl glass
f 1 2 3 4 5
""",
}


def test_cornell_like_matches_jax():
    for t, j in zip(tscenes.cornell_like(), jscenes.cornell_like()):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", ["prism_scene", "single_triangle"])
def test_test_scenes_match_jax(name):
    """prism_scene and single_triangle give the JAX package's arrays,
    array for array (triangles, material ids, material rows)."""
    got, want = getattr(tscenes, name)(), getattr(jscenes, name)()
    assert len(got) == len(want) == 3
    for t, j in zip(got, want):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    if name == "single_triangle":
        mat = tscenes.mat_row(kd=(0.1, 0.2, 0.3), roughness=0.5)
        for t, j in zip(tscenes.single_triangle(mat),
                        jscenes.single_triangle(mat)):
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_subdivide_matches_jax(levels):
    tris, tm, _ = jscenes.cornell_like()
    got = tscenes.subdivide(tris, tm, levels=levels)
    want = jscenes.subdivide(tris, tm, levels=levels)
    assert got[0].shape == (22 * 4 ** levels, 3, 3)
    for t, j in zip(got, want):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_bigscene_rays_match_bigscene_check():
    from benchmarks.bigscene_check import make_rays
    tris, _ = jscenes.subdivide(*jscenes.cornell_like()[:2], levels=2)
    o, d = tkc.bigscene_rays(tris, 1000, 3)
    jo, jd = make_rays(tris, 1000, np.random.default_rng(3))
    assert o.dtype == d.dtype == np.float32 and o.shape == d.shape == (1000, 3)
    np.testing.assert_array_equal(o, np.asarray(jo).T)
    np.testing.assert_array_equal(d, np.asarray(jd).T)


@pytest.mark.parametrize("name", sorted(OBJS))
def test_load_obj_matches_jax(name, tmp_path):
    (tmp_path / "m.mtl").write_text(MTL)
    path = tmp_path / "s.obj"
    path.write_text(OBJS[name])
    got = tobj.load_obj(str(path))
    want = jobj.load_obj(str(path), backend="python")
    for t, j in zip(got, want):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    path.write_text("mtllib m.mtl\nv 0 0 0\nusemtl nothing\n")
    with pytest.raises(ValueError):
        tobj.load_obj(str(path))


def test_key_codes_match_jax():
    names = [n for n in vars(tkeys) if n.isupper()]
    assert "SDLK_UP" in names and "KEYDOWN" in names
    for n in names:
        assert getattr(tkeys, n) == getattr(jkeys, n), n


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_package():
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "tracer_tpu_torch").rglob("*.py"))]
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "tracer_tpu")]
    assert not bad
