"""Port parity: the host-side modules the port keeps of its own (the OBJ
loader, the procedural Cornell box, the SDL key codes) give what the JAX
package's originals give; checkpoint, profiling and argb_to_rgb behave as
their JAX twins; and no source of the port, nor chip_smoke.py, imports
jax or the JAX package."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from tracer_tpu.engine import keys as jkeys
from tracer_tpu.utils import objloader as jobj
from tracer_tpu.utils import testscenes as jscenes
from tracer_tpu.utils import image as jimage
import tracer_tpu_torch as T
from tracer_tpu_torch.engine import keys as tkeys
from tracer_tpu_torch.utils import checkpoint, profiling
from tracer_tpu_torch.utils import image as timage
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


def _small_state(accel="dense", size=8, conf=0):
    return T.init(0, size, size, conf, *tscenes.cornell_like(),
                  cam_origin=(0.0, 0.8, 1.8), accel=accel, device="cpu")


@pytest.mark.parametrize("accel", ["dense", "lbvh"])
def test_checkpoint_save_load_resume(accel, tmp_path):
    """Standalone restore (no template): img, n_frames and nonce resume
    exactly, with either accel."""
    s = T.step(T.step(T.key(tkeys.KEYDOWN, tkeys.SDLK_SPACE,
                            _small_state(accel))))
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, s)
    restored = checkpoint.load(p, device="cpu")
    assert type(restored.scene.accel) is type(s.scene.accel)
    assert (restored.n_frames, restored.nonce, restored.seed,
            restored.mode) == (s.n_frames, s.nonce, s.seed, s.mode) \
        == (2, 2, 0, True)
    assert torch.equal(restored.img, s.img)
    for (ka, a), (kb, b) in zip(s.scene.state_dict().items(),
                                restored.scene.state_dict().items()):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
    for a, b in zip(s.cam.conf, restored.cam.conf):
        assert torch.equal(a, b)
    a, b = T.step(s), T.step(restored)
    assert a.nonce == b.nonce == 3
    assert torch.equal(a.img, b.img)
    # a matching template passes
    checkpoint.load(p, template=_small_state(accel), device="cpu")


def test_checkpoint_rejects_mismatched_template(tmp_path):
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, _small_state())
    with pytest.raises(ValueError, match="does not match template"):
        checkpoint.load(p, template=_small_state(size=16), device="cpu")
    with pytest.raises(ValueError, match="render_mode=color"):
        checkpoint.load(p, template=_small_state(conf=2), device="cpu")


def test_checkpoint_refuses_pickled_object(tmp_path):
    """A file that holds a pickled object (and so could carry code) is
    refused: load reads with allow_pickle=False, and save writes none."""
    import json
    p = str(tmp_path / "ck.npz")
    s = _small_state()
    checkpoint.save(p, s)
    good = np.load(p, allow_pickle=False)
    arrays = {k: good[k] for k in good.files}    # every leaf reads plainly
    assert all(a.dtype != object for a in arrays.values())
    evil = dict(arrays, img=np.array([[eval]], dtype=object))
    np.savez_compressed(str(tmp_path / "evil.npz"), **evil)
    with pytest.raises(ValueError, match="allow_pickle=False"):
        checkpoint.load(str(tmp_path / "evil.npz"), device="cpu")
    static = json.loads(bytes(arrays["__static__"]).decode())
    static["version"] = 99
    arrays["__static__"] = np.frombuffer(json.dumps(static).encode(),
                                         dtype=np.uint8)
    np.savez_compressed(str(tmp_path / "v99.npz"), **arrays)
    with pytest.raises(ValueError, match="unsupported checkpoint version"):
        checkpoint.load(str(tmp_path / "v99.npz"), device="cpu")


def test_phase_timer_on_cpu():
    t = profiling.PhaseTimer(device="cpu")
    x = torch.arange(8.0)
    with t.phase("a"):
        x = x + 1
    with t.phase("a"):
        pass
    with t.phase("b"):
        x = x * 2
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert t.totals["a"] >= 0.0
    assert "a" in t.report() and "2 calls" in t.report()
    assert "total_s" in t.as_json()
    with pytest.raises(RuntimeError):
        with t.phase("c"):
            raise RuntimeError("phase body failed")
    assert t.counts["c"] == 1    # a failing phase is still counted


def test_device_trace_on_cpu(tmp_path):
    with profiling.device_trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.arange(64.0).sum()
    assert any("sum" in e.key for e in prof.key_averages())
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_argb_to_rgb_roundtrip_with_render():
    fb = np.asarray([[0xFF112233, 0xFF445566]], np.uint32)
    rgb = timage.argb_to_rgb(fb)
    assert rgb.dtype == np.uint8
    assert rgb[0, 0].tolist() == [0x11, 0x22, 0x33]
    assert rgb[0, 1].tolist() == [0x44, 0x55, 0x66]
    np.testing.assert_array_equal(rgb, jimage.argb_to_rgb(fb))
    s, argb = T.step_render(_small_state())
    got = timage.argb_to_rgb(argb.cpu().numpy())
    want = (np.clip(s.img.numpy(), 0.0, 1.0) * 255.0).astype(np.uint8)
    assert got.shape == (8, 8, 3) and got.max() > 0
    np.testing.assert_array_equal(got, want)
