"""Golden-image comparisons against the reference's own checked-in renders
(SURVEY.md §4: the reference's validation is golden-image-by-eyeball; these
tests make it quantitative).

Comparisons are in TONEMAPPED space at reduced resolution (box filter).
Tolerances account for (a) Monte-Carlo noise in the low-spp goldens and
(b) gamma concavity making noisier renders slightly darker on average.
"""

import dataclasses

import jax
import numpy as np
import pytest
from PIL import Image

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.io.image import read_png, tonemap_srgb
from tinyraytracing_tpu.render import render


def _load_back(scenes, with_bvh=False):
    """The reference's 26-triangle smoke scene test/back."""
    from tinyraytracing_tpu.models.scene import load_scene

    base = f"{scenes}/test"
    return load_scene(f"{base}/back.xml", f"{base}/back.obj",
                      f"{base}/back.mtl", base, with_bvh=with_bvh)


def _golden(path, size):
    img = read_png(path)
    return np.asarray(
        Image.fromarray(img).resize((size, size), Image.BOX), np.float64
    )


@pytest.mark.slow
def test_back_scene_matches_golden(reference_scenes):
    scene, cam = _load_back(reference_scenes)
    size, spp = 64, 24
    cam = dataclasses.replace(cam, width=size, height=size)
    cfg = RenderConfig(intersector="mxu", max_depth=10, tri_chunk=64)
    ours = tonemap_srgb(
        np.asarray(render(scene, cam, jax.random.PRNGKey(0), cfg, spp))
    ).astype(np.float64)
    gold = _golden(f"{reference_scenes}/test/image10.png", size)

    # The golden is a 10-spp render: per-pixel MC noise is large, and the
    # concave tonemap + uint8 clipping systematically DARKEN noisy renders
    # (E[g(X)] < g(E[X])), so our cleaner render reads ~10-16% brighter.
    # The tight cross-implementation fidelity check is
    # test_cornell_matches_cpu_reference_render below; here we bound the
    # drift and require strong structural correlation.
    for c in range(3):
        rel = abs(ours[..., c].mean() - gold[..., c].mean()) / gold[..., c].mean()
        assert rel < 0.2, (c, rel)
        assert ours[..., c].mean() > gold[..., c].mean() - 2  # brighter side only
    for sl in (np.s_[:32, :32], np.s_[:32, 32:], np.s_[32:, :32], np.s_[32:, 32:]):
        rel = abs(ours[sl].mean() - gold[sl].mean()) / gold[sl].mean()
        assert rel < 0.25, (sl, rel)
    # pixelwise correlation: same image content, not just same brightness
    a = ours.mean(-1).ravel() - ours.mean()
    b = gold.mean(-1).ravel() - gold.mean()
    corr = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    assert corr > 0.85, corr


@pytest.mark.slow
def test_cornell_matches_cpu_reference_render():
    """Cross-implementation fidelity: our renderer vs the CPU
    reimplementation of the reference estimator (baselines/cpu_reference.cc)
    on the same synthesized cornell geometry."""
    import os
    import subprocess

    from tinyraytracing_tpu.models.procedural import cornell_box

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    exe = os.path.join(root, "baselines", "cpu_ref")
    if not os.path.exists(exe):
        try:
            subprocess.run(
                ["g++", "-O3", "-fopenmp", "-std=c++17",
                 os.path.join(root, "baselines", "cpu_reference.cc"), "-o", exe],
                check=True, capture_output=True, timeout=180,
            )
        except Exception:
            pytest.skip("no native toolchain")
    out = os.path.join(root, "baselines", "_test_cornell.ppm")
    subprocess.run([exe, "96", "96", "24", out], check=True, capture_output=True)
    with open(out, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        f.readline()
        ref = np.frombuffer(f.read(), np.uint8).reshape(h, w, 3).astype(np.float64)

    scene, cam = cornell_box(width=96, height=96)
    cfg = RenderConfig(intersector="mxu", max_depth=10, tri_chunk=64)
    ours = tonemap_srgb(
        np.asarray(render(scene, cam, jax.random.PRNGKey(1), cfg, 24))
    ).astype(np.float64)

    for c in range(3):
        rel = abs(ours[..., c].mean() - ref[..., c].mean()) / ref[..., c].mean()
        assert rel < 0.06, (c, rel)
    a = ours.mean(-1).ravel() - ours.mean()
    b = ref.mean(-1).ravel() - ref.mean()
    corr = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    assert corr > 0.92, corr


def _run_cpu_ref_scene(scenes, name, spp, w, h):
    """Render a reference scene with the CPU reimplementation of the
    reference estimator (baselines/cpu_reference.cc --scene) and return
    the uint8 image as float64 (h, w, 3)."""
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    exe = os.path.join(root, "baselines", "cpu_ref")
    if not os.path.exists(exe):
        try:
            subprocess.run(
                ["g++", "-O3", "-fopenmp", "-std=c++17",
                 os.path.join(root, "baselines", "cpu_reference.cc"), "-o", exe],
                check=True, capture_output=True, timeout=180,
            )
        except Exception:
            pytest.skip("no native toolchain")
    base = f"{scenes}/{name}"
    stem = {"veach-mis": "veach-mis", "test": "back"}[name]
    out = f"/tmp/_xcheck_{stem}.ppm"
    subprocess.run(
        [exe, "--scene", f"{base}/{stem}.xml", f"{base}/{stem}.obj",
         f"{base}/{stem}.mtl", str(spp), out, str(w), str(h)],
        check=True, capture_output=True, timeout=300,
    )
    with open(out, "rb") as f:
        assert f.readline().strip() == b"P6"
        rw, rh = map(int, f.readline().split())
        f.readline()
        ref = np.frombuffer(f.read(), np.uint8).reshape(rh, rw, 3)
    return ref.astype(np.float64)


def _xcheck(ours, ref, mean_tol, corr_min, block_p99, block_max, block=8):
    """Estimator-level comparison at EQUAL spp: per-channel means (MC
    noise of a whole-image mean is tiny), pixel correlation, and 8x8
    block-mean errors bounded by calibrated MC-noise bands."""
    for c in range(3):
        rel = abs(ours[..., c].mean() - ref[..., c].mean()) / ref[..., c].mean()
        assert rel < mean_tol, (c, rel)
    a = ours.mean(-1).ravel() - ours.mean()
    b = ref.mean(-1).ravel() - ref.mean()
    corr = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    assert corr > corr_min, corr
    h, w = ours.shape[:2]
    ob = ours.reshape(h // block, block, w // block, block, 3).mean((1, 3, 4))
    rb = ref.reshape(h // block, block, w // block, block, 3).mean((1, 3, 4))
    rel = np.abs(ob - rb) / np.maximum(rb, 5.0)
    assert np.percentile(rel, 99) < block_p99, np.percentile(rel, 99)
    assert rel.max() < block_max, rel.max()


@pytest.mark.slow
def test_veach_matches_cpu_reference_estimator(reference_scenes):
    """veach-mis (2,332 tris, 3 lights, Ns up to 1000) at equal spp vs
    cpu_ref --scene: the flagship queue renderer in full reference-quirk
    mode. Calibrated bounds ~2x the observed discrepancy (mean err 0.25%,
    block p99 7.6%, corr 0.958 at 8 spp)."""
    import dataclasses

    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit
    from tinyraytracing_tpu.models.scene import load_scene

    base = f"{reference_scenes}/veach-mis"
    scene, cam = load_scene(f"{base}/veach-mis.xml", f"{base}/veach-mis.obj",
                            f"{base}/veach-mis.mtl", base, with_bvh=True)
    cam = dataclasses.replace(cam, width=128, height=72)
    cfg = RenderConfig(intersector="bvh", max_depth=16, light_sampler="ref",
                       specular_weight="ref", shadow_test="mtl")
    ours = tonemap_srgb(np.asarray(render_fused_queue_jit(
        scene, cam, jax.random.PRNGKey(0), cfg, 8, lanes=16384
    ))).astype(np.float64)
    ref = _run_cpu_ref_scene(reference_scenes, "veach-mis", 8, 128, 72)
    _xcheck(ours, ref, mean_tol=0.015, corr_min=0.93,
            block_p99=0.15, block_max=0.25)


@pytest.mark.slow
def test_back_matches_cpu_reference_estimator(reference_scenes):
    """test/back (26 tris) at equal spp vs cpu_ref --scene — much tighter
    than the checked-in-golden eyeball test above."""
    import dataclasses

    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit

    scene, cam = _load_back(reference_scenes, with_bvh=True)
    cam = dataclasses.replace(cam, width=96, height=96)
    cfg = RenderConfig(intersector="bvh", max_depth=16, light_sampler="ref",
                       specular_weight="ref", shadow_test="mtl")
    ours = tonemap_srgb(np.asarray(render_fused_queue_jit(
        scene, cam, jax.random.PRNGKey(0), cfg, 16, lanes=8192
    ))).astype(np.float64)
    ref = _run_cpu_ref_scene(reference_scenes, "test", 16, 96, 96)
    _xcheck(ours, ref, mean_tol=0.03, corr_min=0.93,
            block_p99=0.2, block_max=0.35)
