"""End-to-end smoke renders of the remaining reference scenes: veach-mis
(3 lights, Phong exponents to 1000) and staircase (6 lights, 31K triangles,
3 textures, glass Ni=1.5). Small resolution/spp; verifies the full pipeline
(parsers -> BVH -> wavefront -> textures) and coarse agreement with the
reference's checked-in renders."""

import dataclasses

import jax
import numpy as np
import pytest
from PIL import Image

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.io.image import read_png, tonemap_srgb
from tinyraytracing_tpu.models.scene import load_scene
from tinyraytracing_tpu.render import render


def _run(scenes, name, w=96, h=54, spp=2, depth=4):
    scene, cam = load_scene(
        f"{scenes}/{name}/{name}.xml",
        f"{scenes}/{name}/{name}.obj",
        f"{scenes}/{name}/{name}.mtl",
        f"{scenes}/{name}",
        with_bvh=True,
    )
    cam = dataclasses.replace(cam, width=w, height=h)
    cfg = RenderConfig(intersector="bvh", max_depth=depth, ray_chunk=4096)
    img = np.asarray(render(scene, cam, jax.random.PRNGKey(0), cfg, spp))
    return scene, img


@pytest.mark.slow
def test_veach_mis(reference_scenes):
    scenes = reference_scenes
    scene, img = _run(scenes, "veach-mis")
    assert scene.num_triangles == 2332 and scene.num_lights == 3
    # the NEE first-light-range quirk needs light1 first
    assert scene.light_names[0] == "light1"
    assert float(scene.nee_range) == pytest.approx(float(scene.light_area[0]))
    assert np.isfinite(img).all() and img.mean() > 0.05
    ours = tonemap_srgb(img).astype(np.float64)
    gold = np.asarray(
        Image.fromarray(read_png(f"{scenes}/veach-mis/image10.png")).resize(
            (96, 54), Image.BOX
        ),
        np.float64,
    )
    a = ours.mean(-1).ravel() - ours.mean()
    b = gold.mean(-1).ravel() - gold.mean()
    corr = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    assert corr > 0.8, corr


@pytest.mark.slow
def test_staircase_textures(reference_scenes):
    scene, img = _run(reference_scenes, "staircase", spp=2, depth=3)
    assert scene.num_triangles == 31407 and scene.num_lights == 6
    assert scene.tex.shape[0] == 3  # Tiles/Wallpaper/wood5
    assert int(scene.tex_id.max()) >= 0
    assert float(scene.ni.max()) == pytest.approx(1.5)  # glass present
    assert np.isfinite(img).all() and img.mean() > 0.05
