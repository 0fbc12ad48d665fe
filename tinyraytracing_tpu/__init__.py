"""tinyraytracing_tpu — a differentiable wavefront path tracer in JAX.

Capability-parity, from-scratch rebuild of the reference CPU renderer
(Chairy-neko/TinyRayTracing, a C++17 Monte-Carlo path tracer) as batched
fixed-shape array programs under ``jax.jit``: a wavefront integrator
(``lax.scan`` over bounce depth with survival masks) replacing the
reference's per-ray recursion (reference: RayTracingOnCPU/pathTracing.cpp:3-102),
SoA scene buffers in device memory, a CUDA kernel for the hot trace on the
GPU (``ops/trace_kernel.cu``), and ``shard_map`` over a device mesh replacing
the reference's single OpenMP pragma (reference: RayTracingOnCPU/main.cpp:79-81).

Package layout
--------------
- ``io/``         host-side parsers (XML scene / OBJ / MTL / textures) and PNG out
- ``models/``     scene + camera + material/light device representations
- ``ops/``        compute kernels: intersection, BVH build/traversal, sampling
- ``integrator/`` wavefront path-tracing loop (NEE, Russian roulette, BSDFs)
- ``diff/``       differentiable rendering / inverse-rendering utilities
- ``parallel/``   device-mesh sharding, distributed render & gradient reduction
- ``utils/``      timing, logging, checkpointing
"""

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.render import render, render_image, tonemap
from tinyraytracing_tpu.models.scene import Scene, load_scene

__all__ = [
    "RenderConfig",
    "render",
    "render_image",
    "tonemap",
    "Scene",
    "load_scene",
]

__version__ = "0.1.0"
