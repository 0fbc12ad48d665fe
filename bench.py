"""Benchmark driver — prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "scenes": {...}}

Headline metric: the GEOMEAN of full-render traced-rays/s over the three
reference scenes (the representative number; per-scene values ride along
in "scenes"):

- cornell 512x512 @ 16 spp (32 tris)       — fused pixel-persistent
- veach-mis 1280x720 @ 8 spp (2,332 tris)  — queue-fed fused, chunked
- staircase 1280x720 @ 8 spp (31,407 tris) — queue-fed fused, chunked
  (the reference's flagship scene: 6 lights, 3 textures, glass)

``vs_baseline`` is the geomean of per-scene ratios against the measured
CPU reference baseline
(baselines/cpu_scenes.json: the reference algorithm reimplemented in
baselines/cpu_reference.cc, run on this machine's 2 cores — the reference
itself publishes no numbers).

Env knobs: BENCH_SCENES="cornell veach staircase" subset, BENCH_SPP,
BENCH_LANES, BENCH_LANES_QUEUE, BENCH_LEAF (big-scene BVH leaf width
override; estimator-independent), BENCH_GRAD=0 to skip the gradient
section.

FAILURE-HONEST AGGREGATION: a scene that errors contributes rays_per_s=0
to the headline geomean (zeroing it) rather than being dropped — a
transient fault must never inflate the headline vs runs where the scene
ran. The JSON records scenes_ok / scenes_failed.

Runs on whatever jax.devices() provides. The queue scenes go through the
host-chunked driver (integrator/fused_queue.py), the renderer users get.
"""

from __future__ import annotations

import json
import os
import time

import jax

SCENES_DIR = "/root/reference/RayTracingOnCPU/example-scenes-cg22"


def _bench(render, *args, **kwargs):
    """(rays/s, mean): best of two warm runs (the first run pays compile +
    buffer setup, and a single warm sample under-reports)."""
    img, rays = render(*args, **kwargs)
    jax.block_until_ready(img)
    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        img, rays = render(*args, **kwargs)
        jax.block_until_ready(img)
        dt = time.perf_counter() - t0
        best = max(best, float(rays) / dt)
    return best, float(img.mean())


def main():
    from tinyraytracing_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.integrator.fused import render_fused_stats_jit
    from tinyraytracing_tpu.integrator.fused_queue import (
        render_fused_queue_chunked,
    )
    from tinyraytracing_tpu.models.procedural import cornell_box
    from tinyraytracing_tpu.models.scene import load_scene
    from tinyraytracing_tpu.ops.bvh import attach_bvh

    which = os.environ.get("BENCH_SCENES", "cornell veach staircase").split()
    spp = int(os.environ.get("BENCH_SPP", 8))
    lanes = int(os.environ.get("BENCH_LANES", 262144))
    # per-scene queue lane counts (fixed per-iteration costs scale with
    # R); tuned on the previous accelerator, not re-measured on the GPU
    qlanes_env = os.environ.get("BENCH_LANES_QUEUE")
    qlanes = {
        "veach-mis": int(qlanes_env or 65536),
        "staircase": int(qlanes_env or 131072),
    }
    # per-scene BVH leaf width (estimator-independent); tuned on the
    # previous accelerator, not re-measured on the GPU
    leaf_env = os.environ.get("BENCH_LEAF")
    leaves = {
        "veach-mis": int(leaf_env or 32),
        "staircase": int(leaf_env or 16),
    }
    key = jax.random.PRNGKey(0)
    results = {}

    # per-scene isolation: a transient device error on one scene
    # must not zero out the whole benchmark record
    if "cornell" in which:
        try:
            cfg = RenderConfig(intersector="auto", max_depth=16)
            scene, cam = cornell_box(width=512, height=512)
            scene = attach_bvh(scene, cfg)
            cspp = int(os.environ.get("BENCH_SPP_CORNELL", 16))
            rps, mean = _bench(
                render_fused_stats_jit, scene, cam, key, cfg, cspp, lanes
            )
            results["cornell512"] = dict(rays_per_s=round(rps, 1), mean=round(mean, 4))
        except Exception as e:                       # pragma: no cover
            results["cornell512"] = dict(rays_per_s=0.0, error=str(e)[:120])

    for name, tag in (("veach-mis", "veach"), ("staircase", "staircase")):
        if tag not in which and name not in which:
            continue
        try:
            cfg_big = RenderConfig(intersector="auto", max_depth=16,
                                   leaf_size=leaves[name])
            scene, cam = load_scene(
                f"{SCENES_DIR}/{name}/{name}.xml",
                f"{SCENES_DIR}/{name}/{name}.obj",
                f"{SCENES_DIR}/{name}/{name}.mtl",
                f"{SCENES_DIR}/{name}", with_bvh=True,
                leaf_size=leaves[name],
            )
            rps, mean = _bench(
                render_fused_queue_chunked, scene, cam, key, cfg_big, spp,
                lanes=qlanes[name], target_chunk_s=10.0,
            )
            results[name] = dict(rays_per_s=round(rps, 1), mean=round(mean, 4))
        except Exception as e:                       # pragma: no cover
            results[name] = dict(rays_per_s=0.0, error=str(e)[:120])

    base = {}
    bpath = os.path.join(os.path.dirname(__file__), "baselines", "cpu_scenes.json")
    if os.path.exists(bpath):
        with open(bpath) as f:
            base = {k: v["rays_per_s"] for k, v in json.load(f)["scenes"].items()}

    record = aggregate(results, base, bpath)
    if os.environ.get("BENCH_GRAD", "1") != "0":
        record["grad"] = _grad_bench()
    print(json.dumps(record))


def _grad_bench():
    """Driver-captured fwd+bwd rays/s (the BASELINE.json north-star
    metric): value_and_grad of the fast-path MSE loss (diff/fast.py) on
    the three reference scenes, kd grads everywhere plus the
    kd+vertex+eye config on cornell. Failures are recorded per config
    (rays_per_s=0 + error), not silently dropped."""
    import jax.numpy as jnp

    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.diff.fast import render_diff, render_loss_fast
    from tinyraytracing_tpu.diff.inverse import SceneParams
    from tinyraytracing_tpu.models.procedural import cornell_box
    from tinyraytracing_tpu.models.scene import load_scene
    from tinyraytracing_tpu.ops.bvh import attach_bvh

    key = jax.random.PRNGKey(0)
    out = {}

    def one(tag, scene, cam, spp, fields, depth=8, leaf=32):
        try:
            cfg = RenderConfig(intersector="auto", max_depth=depth,
                               leaf_size=leaf)
            target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
            params = SceneParams.init_from(scene, cam, *fields)
            fwd = jax.jit(lambda: render_diff(scene, cam, key, cfg, spp,
                                              return_rays=True))
            img, rays = fwd()
            jax.block_until_ready(img)
            rays = float(rays)
            t0 = time.perf_counter()
            img, _ = fwd()
            jax.block_until_ready(img)
            fwd_s = time.perf_counter() - t0
            vg = jax.jit(jax.value_and_grad(
                lambda p: render_loss_fast(p, scene, cam, key, target, cfg,
                                           spp)))
            loss, g = vg(params)
            jax.block_until_ready(loss)
            best = 0.0
            for _ in range(2):
                t0 = time.perf_counter()
                loss, g = vg(params)
                jax.block_until_ready(loss)
                best = max(best, rays / (time.perf_counter() - t0))
            out[tag] = dict(
                fwd_bwd_rays_per_s=round(best, 1),
                fwd_rays_per_s=round(rays / fwd_s, 1),
                spp=spp, fields=list(fields),
            )
        except Exception as e:                      # pragma: no cover
            out[tag] = dict(fwd_bwd_rays_per_s=0.0, error=str(e)[:120])

    try:
        cfgb = RenderConfig(leaf_size=32)
        scene, cam = cornell_box(width=512, height=512)
        scene = attach_bvh(scene, cfgb)
        one("cornell_kd", scene, cam, 4, ("kd",))
        one("cornell_kd_vertex_eye", scene, cam, 4,
            ("kd", "vertex_offset", "eye"))
        # per-scene leaf widths match the forward bench
        for name, spp, leaf in (("veach-mis", 2, 32), ("staircase", 1, 16)):
            s, c = load_scene(
                f"{SCENES_DIR}/{name}/{name}.xml",
                f"{SCENES_DIR}/{name}/{name}.obj",
                f"{SCENES_DIR}/{name}/{name}.mtl",
                f"{SCENES_DIR}/{name}", with_bvh=True, leaf_size=leaf,
            )
            one(f"{name}_kd", s, c, spp, ("kd",), leaf=leaf)
    except Exception as e:                          # pragma: no cover
        out["setup_error"] = str(e)[:200]
    return out


def aggregate(results: dict, base: dict, bpath: str = "") -> dict:
    """Fold per-scene results into the headline record. FAILURE-HONEST:
    an errored scene contributes rays_per_s = 0 to the geomean — zeroing
    the headline — instead of silently shrinking the scene set (a scene
    fault must never INFLATE the headline vs rounds where it ran). The
    record lists which scenes ran and which failed."""
    failed = sorted(k for k, r in results.items() if not r.get("rays_per_s", 0))
    ran = sorted(k for k, r in results.items() if r.get("rays_per_s", 0) > 0)
    vals = [r["rays_per_s"] for r in results.values()]
    geomean = 1.0
    for v in vals:
        geomean *= v
    geomean **= 1.0 / max(len(vals), 1)

    # vs_baseline: same failure-honest rule (failed scene -> ratio 0)
    ratios = [
        r["rays_per_s"] / base[k] for k, r in results.items() if k in base
    ]
    vs = 1.0
    for r in ratios:
        vs *= r
    vs **= 1.0 / max(len(ratios), 1)

    # headline value: the 3-scene GEOMEAN (the representative number, not
    # the best case); per-scene
    # results incl. cornell ride along. Scenes missing from the measured
    # CPU baseline are a loud error, not a silent fallback ratio.
    out_results = dict(results)
    missing = [k for k in results if k not in base]
    if missing and ratios:
        out_results["baseline_missing"] = missing
    elif missing:
        raise SystemExit(
            f"no CPU baseline for any measured scene ({missing}); "
            f"re-run baselines/cpu_reference.cc to fill {bpath}"
        )
    return {
        "metric": "full_render_rays_per_s_geomean",
        "value": round(geomean, 1),
        "unit": "rays/s",
        "vs_baseline": round(vs, 4),
        "scenes": out_results,
        "scenes_ok": ran,
        "scenes_failed": failed,
        "geomean_rays_per_s": round(geomean, 1),
        "geomean_vs_cpu_baseline": round(vs, 4),
    }


if __name__ == "__main__":
    main()
