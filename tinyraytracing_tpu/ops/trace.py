"""The trace: closest hit + shading attributes for planar ray batches.

Every renderer traces through ``fused_trace_planes`` (and, for shadow rays,
``occlusion_trace_segmented``). ``use_kernel`` is the one place that picks
how the hits are found:

- ``config.trace == "cuda"``: the CUDA kernel (ops/trace_kernel.cu through
  ops/trace_cuda.py) — one thread per ray walking the binary BVH. Asking
  for it where JAX has no GPU is an error, never a silent substitution;
- ``"xla"``: the plain JAX path — ``ops.intersect.intersect`` with the
  configured intersector, the while-loop BVH walk of ops/traverse.py when
  a BVH is attached;
- ``"auto"`` (default): the kernel on a GPU, the plain path elsewhere.

Both return the same hit record (t, triangle, u, v); everything after it —
the t-bound and target-material semantics, the attribute gathers — is the
shared ``_resolve`` below, so the two paths differ only in how the hit was
found (visit order, FMA contraction).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.models.scene import Scene

_INF = 3.0e38
TRACES = ("auto", "cuda", "xla")


def use_kernel(config: RenderConfig) -> bool:
    """True when the trace runs the CUDA kernel (see module docstring)."""
    if config.trace not in TRACES:
        raise ValueError(f"unknown trace {config.trace!r}; expected {TRACES}")
    if config.trace == "xla":
        return False
    on_gpu = jax.default_backend() == "gpu"
    if config.trace == "cuda" and not on_gpu:
        raise RuntimeError(
            "trace='cuda' needs a GPU backend; JAX is running on "
            f"{jax.default_backend()!r}"
        )
    return on_gpu


def _plain_hits(scene, ox, oy, oz, dx, dy, dz, tb, config):
    """(t, tri, u, v) from the plain JAX intersectors; tri -1 on a miss."""
    from tinyraytracing_tpu.ops.intersect import intersect

    org = jnp.stack([ox, oy, oz], axis=-1)
    d = jnp.stack([dx, dy, dz], axis=-1)
    hit = intersect(scene, org, d, config, t_bound=tb)
    return hit.t, jnp.where(hit.hit, hit.idx, -1), hit.u, hit.v


def _kernel_hits(scene, ox, oy, oz, dx, dy, dz, tb, tg, config):
    """(t, tri, u, v) from the CUDA kernel; tri -1 miss, -2 killed."""
    from tinyraytracing_tpu.ops import trace_cuda

    if scene.bvh is None:
        raise ValueError("the CUDA trace needs a BVH (ops.bvh.attach_bvh)")
    ops = trace_cuda.pack_inputs(scene, ox, oy, oz, dx, dy, dz, tb, tg)
    return trace_cuda.trace_call(
        *ops, t_min=config.t_min, graze=config.n_dot_d_min,
        tie_eps=config.tie_eps,
    )


def _resolve(scene, t, tri, u, v, tb, tg, config, attrs):
    """Hit record -> the trace's output planes.

    t-bound: a hit beyond tb * (1 + tie_eps) (outside the band that admits
    the light surface itself) is a miss. Target material (tg > -1.5, shadow
    rays aimed at a light): the reference's closest-hit material
    visibility (pathTracing.cpp:55-58) — a closest hit of another material
    strictly inside the band occludes (killed: t = -1, mtl = -3); the
    kernel may report the kill itself (tri == -2) when it met such a hit
    first, which for planar or closed lights is the same answer. A
    non-emissive hit of another material inside the band is a miss; an
    emissive one stays a hit (it is a light)."""
    eps = config.tie_eps
    idx = jnp.maximum(tri, 0)
    mtl = scene.tri_mtl[idx].astype(jnp.float32)
    em = scene.tri_emissive[idx].astype(jnp.float32)
    miss = (tri < 0) | (t > tb * (1.0 + eps))
    wrong = ~miss & (tg > -1.5) & (jnp.abs(mtl - tg) > 0.5)
    killed = (tri == -2) | (wrong & (t * (1.0 + eps) < tb))
    miss = miss | (wrong & ~killed & ~(em > 0.5))
    gone = miss | killed
    t_out = jnp.where(killed, -1.0, jnp.where(miss, jnp.minimum(tb, _INF), t))
    mtl_out = jnp.where(killed, -3.0, jnp.where(miss, -1.0, mtl))
    em_out = jnp.where(gone, 0.0, em)
    tri_out = jnp.where(gone, -1.0, idx.astype(jnp.float32))
    zero = jnp.zeros_like(t)
    if not attrs:
        return t_out, zero, zero, zero + 1.0, zero, zero, mtl_out, em_out, tri_out
    w = 1.0 - u - v
    interp = lambda a, b, c, k: jnp.where(
        gone, 0.0, a[idx, k] * w + b[idx, k] * u + c[idx, k] * v
    )
    pnz = jnp.where(gone, 1.0, interp(scene.n0, scene.n1, scene.n2, 2))
    return (t_out, interp(scene.n0, scene.n1, scene.n2, 0),
            interp(scene.n0, scene.n1, scene.n2, 1), pnz,
            interp(scene.t0, scene.t1, scene.t2, 0),
            interp(scene.t0, scene.t1, scene.t2, 1),
            mtl_out, em_out, tri_out)


@functools.partial(
    jax.jit, static_argnames=("config", "return_tri", "attrs", "query")
)
def fused_trace_planes(scene: Scene, ox, oy, oz, dx, dy, dz,
                       config: RenderConfig, t_bound=None, target_mtl=None,
                       return_tri: bool = False, attrs: bool = True,
                       query: str = "closest"):
    """Closest-hit + shading-attribute trace.

    Planar in, planar out: six (R,) ray component planes -> a tuple of
    (t, pn_x, pn_y, pn_z, tc_u, tc_v, mtl, em) (R,) planes. ``pn`` is the
    UNNORMALIZED barycentric-interpolated shading normal (the integrator
    normalizes once), ``tc`` the interpolated texcoord, ``mtl`` the
    material id carried as f32 (misses -1, killed lanes -3), ``em`` the hit
    triangle's emissive flag. Misses keep t at the bound (INF by default).

    ``t_bound``: optional (R,) per-ray bound. Shadow queries pass the light
    distance, so the walk never looks beyond the light; a bound of 0 parks
    the lane. ``target_mtl``: per-ray light material for the shadow
    visibility test (-2 disables it); semantics in ``_resolve``.

    ``attrs=False`` skips the attribute gathers (pn = (0, 0, 1), tc = 0).
    ``return_tri`` appends the hit triangle index as f32 (-1 for a miss or
    a killed lane) — what the path-replay backward (diff/fast.py) needs.

    ``query="occlusion"``: return just (bt, seen) — bt = -1 where another
    material occluded the lane (else the bound), seen = 1 where the closest
    hit within the band is the target material. Reference visibility is
    ``(seen > 0.5) & (bt >= 0)``.
    """
    if t_bound is None:
        t_bound = jnp.full_like(ox, _INF)
    if target_mtl is None:
        target_mtl = jnp.full_like(ox, -2.0)
    if use_kernel(config):
        hits = _kernel_hits(scene, ox, oy, oz, dx, dy, dz, t_bound,
                            target_mtl, config)
    else:
        hits = _plain_hits(scene, ox, oy, oz, dx, dy, dz, t_bound, config)
    occl = query == "occlusion"
    out = _resolve(scene, *hits, t_bound, target_mtl, config,
                   attrs and not occl)
    if occl:
        killed = out[6] == -3.0
        seen = (out[6] >= 0.0) & (jnp.abs(out[6] - target_mtl) <= 0.5)
        return jnp.where(killed, -1.0, t_bound), seen.astype(jnp.float32)
    return out if return_tri else out[:8]


def occlusion_trace_segmented(scene: Scene, ox, oy, oz, dx, dy, dz,
                              t_bound, target_mtl, config: RenderConfig,
                              n_seg: int):
    """Occlusion query over ``n_seg`` concatenated equal segments of
    shadow lanes (one per light), with optional per-segment LIVE-LANE
    COMPACTION (config.shadow_compact; fused_queue's shadow dispatch and
    diff/fast's replay both use this). Returns ONE (n_seg * R,) f32
    VISIBILITY plane: 1.0 where the closest hit within the band of the
    bound is the target material and nothing of another material occluded
    the lane (the reference's material-equality visibility,
    pathTracing.cpp:55-58) — parked lanes (t_bound == 0) report 0.

    Compaction: one batched stable (n_seg, R) lax.sort packs live lanes to
    each segment's front, an inverse sort restores lane order. Per-lane
    results do not depend on a lane's neighbours, so the returned
    visibility is the uncompacted dispatch's
    (tests/test_trace.py::test_fused_queue_shadow_compact_bitwise).
    target_mtl is NOT sorted: within a segment every live lane shares the
    segment's light material, so it is re-broadcast from the sorted bound
    instead (parked lanes never test material).

    "auto" compacts trees of more than 4096 nodes, where the walk is long
    enough to be worth two sorts; whether it pays on the GPU is not
    measured yet.
    """
    n_nodes = scene.bvh.n_nodes if scene.bvh is not None else 0
    compact = config.shadow_compact == "on" or (
        config.shadow_compact == "auto" and n_nodes > 4096
    )
    vis = lambda bt, seen: ((seen > 0.5) & (bt >= 0.0)).astype(jnp.float32)
    if not compact or n_seg * 128 > ox.shape[0]:
        bt, seen = fused_trace_planes(
            scene, ox, oy, oz, dx, dy, dz, config,
            t_bound=t_bound, target_mtl=target_mtl, query="occlusion",
        )
        return vis(bt, seen)
    from tinyraytracing_tpu.ops.sort import sort_planes_by

    R = ox.shape[0] // n_seg
    seg = lambda x: x.reshape(n_seg, R)
    dead = (seg(t_bound) <= 0.0).astype(jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (n_seg, R), 1)
    srt = sort_planes_by(
        dead,
        (seg(ox), seg(oy), seg(oz), seg(dx), seg(dy), seg(dz),
         seg(t_bound), lane),
        axis=1,
    )
    # per-segment target material, re-broadcast onto the live prefix
    # (live lanes of a segment all target the same light; -inf when the
    # whole segment is parked, in which case no lane reads it)
    seg_tg = jnp.max(
        jnp.where(seg(t_bound) > 0.0, seg(target_mtl), -jnp.inf),
        axis=1, keepdims=True,
    )
    ctg = jnp.where(srt[6] > 0.0, seg_tg, -2.0)
    flat = lambda a: a.reshape(n_seg * R)
    cbt, cseen = fused_trace_planes(
        scene, flat(srt[0]), flat(srt[1]), flat(srt[2]),
        flat(srt[3]), flat(srt[4]), flat(srt[5]),
        config, t_bound=flat(srt[6]), target_mtl=flat(ctg),
        query="occlusion",
    )
    # inverse permutation: lane ids are unique per segment, so sorting by
    # them restores original order exactly (2 operands — no packing)
    _, rvis = jax.lax.sort(
        (srt[7], seg(vis(cbt, cseen))), dimension=1, num_keys=1,
        is_stable=True,
    )
    return flat(rvis)
