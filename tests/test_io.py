"""Parser tests against the reference scene assets (skipped when they are
absent) and against the cornell box kept in tests/data; PNG output.

Expected numbers come from the reference's own printf output semantics
(scene.cpp:209-212) and direct inspection of the assets:
veach-mis.obj has 2,332 ``f`` records, staircase.obj 31,407 (SURVEY.md §0).
"""

import io
import os

import numpy as np
import pytest

from tinyraytracing_tpu.io.image import encode_png, tonemap_srgb
from tinyraytracing_tpu.io.mtl import parse_mtl
from tinyraytracing_tpu.io.objmesh import parse_obj, triangle_areas
from tinyraytracing_tpu.io.xmlscene import parse_scene_xml


def test_xml_test_scene(reference_scenes):
    cfg = parse_scene_xml(f"{reference_scenes}/test/back.xml")
    assert (cfg.width, cfg.height) == (1024, 1024)
    assert cfg.fovy == pytest.approx(39.3077)
    assert cfg.eye == pytest.approx((278.0, 273.0, -800.0))
    assert cfg.lookat == pytest.approx((278.0, 273.0, -799.0))
    assert cfg.up == (0.0, 1.0, 0.0)
    assert len(cfg.lights) == 1
    assert cfg.lights[0].mtl_name == "back:Light"
    assert cfg.lights[0].radiance == pytest.approx((34.0, 24.0, 8.0))


def test_xml_multiline_radiance(reference_scenes):
    # staircase.xml carries newlines inside radiance attributes
    cfg = parse_scene_xml(f"{reference_scenes}/staircase/staircase.xml")
    assert len(cfg.lights) == 6
    names = [l.mtl_name for l in cfg.lights]
    assert names[0] == "ceilingLight"  # light order is load-bearing (NEE quirk)
    left = dict(zip(names, [l.radiance for l in cfg.lights]))["leftLight"]
    assert left == pytest.approx((2.742004577636719, 2.1547576084136963, 0.9237708320617676))


def test_mtl_defaults_and_kt_quirk(reference_scenes):
    mats = parse_mtl(f"{reference_scenes}/test/back.mtl")
    m = mats["back:DiffuseWhite"]
    assert m.kd == pytest.approx((0.79, 0.76, 0.73))
    # 'Kt' is NOT parsed by the reference (only 'Tr', scene.cpp:90-94):
    assert m.tr == (0.0, 0.0, 0.0)
    assert m.ns == 1.0 and m.ni == 1.0
    mats2 = parse_mtl(f"{reference_scenes}/test/back.mtl", kt_as_tr=True)
    assert mats2["back:DiffuseWhite"].tr == pytest.approx((1.0, 1.0, 1.0))


def test_obj_test_scene(reference_scenes):
    mesh = parse_obj(f"{reference_scenes}/test/back.obj")
    assert mesh.num_triangles == 26
    # geometric normals are unit
    assert np.allclose(np.linalg.norm(mesh.normal, axis=1), 1.0, atol=1e-12)
    # two 130x105 light quads (4 triangles of area 6825 each)
    light_ids = [i for i, n in enumerate(mesh.mtl_names) if n == "back:Light"]
    sel = mesh.mtl == light_ids[0]
    assert sel.sum() == 4
    assert triangle_areas(mesh.v)[sel].sum() == pytest.approx(2 * 130 * 105.0, rel=1e-6)


def test_obj_counts_reference_assets(reference_scenes):
    assert parse_obj(f"{reference_scenes}/veach-mis/veach-mis.obj").num_triangles == 2332


@pytest.mark.slow
def test_obj_staircase(reference_scenes):
    mesh = parse_obj(f"{reference_scenes}/staircase/staircase.obj")
    assert mesh.num_triangles == 31407
    # staircase declares vn before vt -> isvnvt stays True there
    assert np.abs(mesh.vn).sum() > 0


def test_tonemap_matches_reference_cast():
    x = np.array([[[0.0, 0.5, 1.0]]])
    out = tonemap_srgb(x)
    # pow(0.5, 1/2.2)*255 = 186.51... -> truncates to 186
    assert out.tolist() == [[[0, 186, 255]]]
    assert tonemap_srgb(np.array([[[2.0, -1.0, 0.2178]]])).tolist() == [[[255, 0, 127]]]


def test_native_matches_python(reference_scenes):
    """Native C++ OBJ parser and BVH builder must agree exactly with the
    Python implementations (skipped when no toolchain)."""
    pytest.importorskip("tinyraytracing_tpu.native")
    try:
        from tinyraytracing_tpu.native import build_bvh_native, parse_obj_native
        m1 = parse_obj_native(f"{reference_scenes}/veach-mis/veach-mis.obj")
    except ImportError:
        pytest.skip("native toolchain unavailable")
    m2 = parse_obj(f"{reference_scenes}/veach-mis/veach-mis.obj")
    assert m1.num_triangles == m2.num_triangles == 2332
    np.testing.assert_allclose(m1.v, m2.v)
    np.testing.assert_allclose(m1.vn, m2.vn)
    np.testing.assert_allclose(m1.vt, m2.vt)
    np.testing.assert_array_equal(m1.mtl, m2.mtl)
    assert m1.mtl_names == m2.mtl_names

    from tinyraytracing_tpu.ops.bvh import build_bvh

    n1, p1 = build_bvh_native(m1.v)
    n2, p2 = build_bvh(m2.v)
    np.testing.assert_array_equal(p1, p2)
    for k in ("start", "count", "skip"):
        np.testing.assert_array_equal(n1[k], n2[k])
    np.testing.assert_allclose(n1["nmin"], n2["nmin"], atol=1e-4)


def test_scene_files_load_as_procedural_cornell(test_scene_paths):
    """tests/data is the cornell box written out in the course format:
    parsing it gives exactly the scene models.procedural builds."""
    import jax

    from tinyraytracing_tpu.models.procedural import cornell_box
    from tinyraytracing_tpu.models.scene import load_scene

    p = test_scene_paths
    a, cam_a = load_scene(p["xml"], p["obj"], p["mtl"], p["basedir"])
    b, cam_b = cornell_box()
    assert a.mtl_names == b.mtl_names and a.light_names == b.light_names
    for x, y in zip(jax.tree_util.tree_leaves((a, cam_a)),
                    jax.tree_util.tree_leaves((b, cam_b))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_scene_files_up_to_date(test_scene_paths, tmp_path):
    """The committed files are what write_cornell_files writes today."""
    from tinyraytracing_tpu.models.procedural import write_cornell_files

    fresh = write_cornell_files(str(tmp_path))
    for k in ("xml", "obj", "mtl"):
        with open(fresh[k]) as f, open(test_scene_paths[k]) as g:
            assert f.read() == g.read(), k


def test_png_roundtrip(rng, tmp_path):
    """write_png needs only zlib + struct; Pillow must decode its output
    to the tonemapped pixels."""
    from PIL import Image

    from tinyraytracing_tpu.io.image import write_png

    x = rng.uniform(0, 2, (7, 11, 3))
    out = tmp_path / "x.png"
    write_png(str(out), x)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), tonemap_srgb(x))
    rgb = (rng.uniform(0, 255, (3, 5, 3))).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(encode_png(rgb)))), rgb)


def test_texture_without_pillow_names_package(monkeypatch):
    """Textures are the one Pillow dependency: without it, loading a scene
    with map_Kd raises an error that names the package."""
    import builtins

    from tinyraytracing_tpu.io.textures import load_texture_atlas

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        load_texture_atlas(["tex.png"])
    assert load_texture_atlas([])[0].shape == (1, 1, 1, 3)   # no textures


@pytest.mark.parametrize("env", [None, "given"])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR is honoured as is; otherwise one fixed
    directory inside the checkout."""
    import jax

    from tinyraytracing_tpu.utils import compile_cache

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.CHECKOUT_CACHE
        assert calls["jax_compilation_cache_dir"] == path
        assert os.path.dirname(path) == os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in calls
