"""Command-line driver.

Replaces the reference's interactive stdin prompts (RayTracingOnCPU/
main.cpp:46-55) with proper flags; defaults mirror the reference constants
(SAMPLE=256 at main.cpp:13, etc. — see config.py). Output naming follows the
reference: ``<basedir>/image<SPP>.png`` (main.cpp:26).

Example:
    tinypt --basedir scenes/test --xml back.xml --obj back.obj \
           --mtl back.mtl --spp 64
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tinypt", description=__doc__)
    p.add_argument("--basedir", default=None, help="scene base directory")
    p.add_argument("--xml", default=None, help=".xml scene config (relative to basedir unless absolute)")
    p.add_argument("--obj", default=None, help=".obj mesh path")
    p.add_argument("--mtl", default=None, help=".mtl material library path")
    p.add_argument("--scene", default=None,
                   help="procedural scene instead of files: cornell | "
                        "cornell-specular | grid:<n_triangles>")
    p.add_argument("--spp", type=int, default=256, help="samples per pixel (reference default 256)")
    p.add_argument("--max-depth", type=int, default=16)
    p.add_argument("--p-rr", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=None, help="override XML image width")
    p.add_argument("--height", type=int, default=None, help="override XML image height")
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "persistent", "queue", "scan"],
                   help="auto = flagship fused wavefront (scheduling picked "
                        "by scene size); scan = fixed-depth differentiable path")
    p.add_argument("--lanes", type=int, default=262144,
                   help="wavefront width for the fused renderers")
    p.add_argument("--leaf-size", type=int, default=8,
                   help="BVH leaf width (reference default 8; "
                        "estimator-independent)")
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "mxu", "brute", "bvh"],
                   help="plain-path intersector (the scan renderer, and the "
                        "fused renderers off the GPU)")
    p.add_argument("--light-sampler", default="ref", choices=["ref", "uniform"])
    p.add_argument("--specular-weight", default="ref", choices=["ref", "ks"])
    p.add_argument("--shadow-test", default="mtl", choices=["mtl", "tmin"])
    p.add_argument("--out", default=None, help="output PNG (default basedir/image<SPP>.png)")
    p.add_argument("--checkpoint", default=None,
                   help="lane-state snapshot path for resumable long renders "
                        "(queue renderer); pass with --resume to continue")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if present")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="disable the persistent XLA compilation cache")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import dataclasses

    if not args.no_compile_cache:
        # long XLA compiles are paid once per (scene shape, config)
        # instead of per invocation
        from tinyraytracing_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.models.scene import load_scene
    from tinyraytracing_tpu.render import render_image
    from tinyraytracing_tpu.utils.logging import get_logger
    from tinyraytracing_tpu.utils.timing import Timer

    log = get_logger()
    if args.scene is None and not (args.basedir and args.xml and args.obj and args.mtl):
        raise SystemExit("either --scene or all of --basedir/--xml/--obj/--mtl required")
    rel = lambda p: p if os.path.isabs(p) else os.path.join(args.basedir, p)

    config = RenderConfig(
        spp=args.spp,
        max_depth=args.max_depth,
        p_rr=args.p_rr,
        intersector=args.intersector,
        leaf_size=args.leaf_size,
        light_sampler=args.light_sampler,
        specular_weight=args.specular_weight,
        shadow_test=args.shadow_test,
    )
    # the fused renderers trace a BVH; build it at load unless the user
    # explicitly asked for the scan path with a non-BVH intersector
    with_bvh = (
        args.renderer in ("auto", "persistent", "queue")
        or config.intersector in ("auto", "bvh")
    )
    if args.scene:
        from tinyraytracing_tpu.models.procedural import (
            cornell_box, cornell_box_specular, quad_grid,
        )

        if args.scene == "cornell":
            scene, cam = cornell_box()
        elif args.scene == "cornell-specular":
            scene, cam = cornell_box_specular()
        elif args.scene.startswith("grid:"):
            scene, cam = quad_grid(int(args.scene.split(":")[1]))
        else:
            raise SystemExit(f"unknown --scene {args.scene}")
    else:
        scene, cam = load_scene(
            rel(args.xml), rel(args.obj), rel(args.mtl), args.basedir,
            with_bvh=False,
        )
    if with_bvh:
        from tinyraytracing_tpu.ops.bvh import attach_bvh

        scene = attach_bvh(scene, config)
    if args.width or args.height:
        cam = dataclasses.replace(
            cam, width=args.width or cam.width, height=args.height or cam.height
        )
    log.info(
        "scene: %d triangles, %d materials, %d lights; image %dx%d @ %d spp",
        scene.num_triangles, scene.num_materials, scene.num_lights,
        cam.width, cam.height, args.spp,
    )
    if scene.bvh is not None:
        log.info("BVH: %d nodes", scene.bvh.n_nodes)

    out = args.out or os.path.join(args.basedir or ".", f"image{args.spp}.png")
    prog = lambda it, counter, seconds: log.info(
        "  chunk done: iter=%d paths_started=%d (%.1fs)", it, counter, seconds
    )
    with Timer() as t:
        render_image(scene, cam, config, spp=args.spp, seed=args.seed,
                     out_path=out, renderer=args.renderer, lanes=args.lanes,
                     checkpoint_path=args.checkpoint, resume=args.resume,
                     progress=prog)
    n_rays = cam.width * cam.height * args.spp
    log.info("rendered %s in %.2fs (%.3g camera rays/s)", out, t.elapsed, n_rays / t.elapsed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
