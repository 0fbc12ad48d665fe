"""Distribution over device meshes.

The reference's entire parallel story is one OpenMP pragma over the sample
loop with racy shared accumulation (RayTracingOnCPU/main.cpp:79-113). Here:
``shard_map`` over a 2-D ``Mesh(tile, spp)`` — image tiles (rays) sharded on
one axis, samples on the other, scene/BVH replicated per device, and a
``psum`` over the spp axis replacing the racy ``+=``. XLA collectives
between devices; multi-host via ``jax.distributed`` composes transparently
(the mesh just spans hosts).
"""

from tinyraytracing_tpu.parallel.mesh import make_mesh, render_sharded

__all__ = ["make_mesh", "render_sharded"]
