"""Top-level render driver.

Replaces the reference's OpenMP sample loop with racy shared accumulation
(RayTracingOnCPU/main.cpp:79-113) by a jitted ``lax.scan`` over spp passes:
each pass generates one jittered camera ray per pixel, traces the whole
wavefront, and adds into a functional accumulator — deterministic for a
given key, race-free by construction.

Rays are processed in fixed-size chunks (config.ray_chunk) via an inner scan
so peak memory stays bounded at any resolution.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tinyraytracing_tpu.config import DEFAULT_CONFIG, RenderConfig
from tinyraytracing_tpu.integrator.wavefront import trace
from tinyraytracing_tpu.io.image import tonemap_srgb, write_png
from tinyraytracing_tpu.models.camera import Camera, generate_rays
from tinyraytracing_tpu.models.scene import Scene

tonemap = tonemap_srgb


def render_pass(scene: Scene, cam: Camera, key, config: RenderConfig):
    """One spp pass: (H, W, 3) radiance for one jittered ray per pixel."""
    W, H = cam.width, cam.height
    k_ray, k_trace = jax.random.split(key)
    org, d = generate_rays(cam, k_ray)

    n = org.shape[0]
    chunk = min(config.ray_chunk, n)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        org = jnp.concatenate([org, org[:pad]], axis=0)
        d = jnp.concatenate([d, d[:pad]], axis=0)

    def body(_, xs):
        i, o_c, d_c = xs
        rad = trace(scene, o_c, d_c, jax.random.fold_in(k_trace, i), config)
        return None, rad

    xs = (
        jnp.arange(n_chunks),
        org.reshape(n_chunks, chunk, 3),
        d.reshape(n_chunks, chunk, 3),
    )
    _, rad = jax.lax.scan(body, None, xs)
    rad = rad.reshape(-1, 3)[:n]
    return rad.reshape(H, W, 3)


@partial(jax.jit, static_argnames=("config", "spp"))
def render(
    scene: Scene,
    cam: Camera,
    key,
    config: RenderConfig = DEFAULT_CONFIG,
    spp: int | None = None,
):
    """Render the mean image over ``spp`` passes. Returns (H, W, 3) linear."""
    spp = spp or config.spp

    def body(acc, s):
        img = render_pass(scene, cam, jax.random.fold_in(key, s), config)
        return acc + img, None

    acc0 = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(spp))
    return acc / spp


# Queue scheduling pays a per-iteration scatter-add, which dominates on
# cornell-class scenes whose trace is cheap; on real scenes the queue's
# ~100% occupancy wins (fused_queue.py docstring). The crossover was tuned
# on the previous accelerator and is not measured on the GPU yet.
_QUEUE_MIN_TRIS = 512


def pick_renderer(scene: Scene) -> str:
    """Auto renderer choice: fused pixel-persistent for tiny scenes,
    queue-fed fused wavefront otherwise."""
    return "queue" if scene.num_triangles >= _QUEUE_MIN_TRIS else "persistent"


def render_image(
    scene: Scene,
    cam: Camera,
    config: RenderConfig = DEFAULT_CONFIG,
    spp: int | None = None,
    seed: int = 0,
    out_path: str | None = None,
    renderer: str = "auto",
    lanes: int = 262144,
    checkpoint_path: str | None = None,
    resume: bool = False,
    progress=None,
) -> np.ndarray:
    """Convenience wrapper: render, pull to host, optionally write a PNG
    (reference naming: <basedir>/image<SPP>.png, main.cpp:26). Returns the
    linear (H, W, 3) numpy image.

    ``renderer``: 'auto' (flagship fused wavefront, scheduling picked by
    scene size), 'persistent' (fused pixel-persistent), 'queue' (queue-fed
    fused), or 'scan' (fixed-depth differentiable scan; gradients prefer
    diff.fast.render_diff — the custom-VJP fused path). The queue renderer
    runs host-chunked, which is what gives it checkpoint/resume through
    ``checkpoint_path`` (images are bitwise those of one device program)."""
    spp_val = spp or config.spp
    key = jax.random.PRNGKey(seed)
    if renderer == "auto":
        renderer = pick_renderer(scene)
    if renderer in ("persistent", "queue"):
        if scene.bvh is None:
            from tinyraytracing_tpu.ops.bvh import attach_bvh

            scene = attach_bvh(scene, config)
        if renderer == "persistent":
            from tinyraytracing_tpu.integrator.fused import render_fused_jit

            img = render_fused_jit(scene, cam, key, config, spp_val, lanes)
        else:
            from tinyraytracing_tpu.integrator.fused_queue import (
                render_fused_queue_chunked,
            )

            img, _ = render_fused_queue_chunked(
                scene, cam, key, config, spp_val, lanes,
                checkpoint_path=checkpoint_path, resume=resume,
                progress=progress,
            )
            img = img.reshape(cam.height, cam.width, 3)
    elif renderer == "scan":
        img = render(scene, cam, key, config, spp)
    else:
        raise ValueError(f"unknown renderer {renderer!r}")
    img = np.asarray(img)
    if out_path:
        write_png(out_path, img)
    return img
