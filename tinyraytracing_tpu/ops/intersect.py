"""Ray-scene intersection: batched Möller–Trumbore with reference-faithful
acceptance rules, plus the closest-hit selection with emissive tie-break.

The reference tests triangles with a plane-equation + three-edge-cross inside
test (RayTracingOnCPU/bvh.cpp:177-209) and recovers barycentrics later with a
per-hit Eigen QR solve (triangle.cpp:12-29). Möller–Trumbore produces the
same hit set (up to measure-zero boundary cases) and yields the barycentrics
(u, v) for free, which is exactly the improvement SURVEY.md §2 calls for.

Faithful acceptance rules kept:
- reject when |dot(geometric_normal, dir)| < 1e-5 (bvh.cpp:185)
- reject when t < 5e-4, the implicit shadow-acne epsilon (bvh.cpp:189) —
  the reference applies NO origin offset to secondary rays
- closest hit; on equal distance prefer an emissive triangle
  (bvh.cpp:168-174,219 — "choose Emissive triangle when they are
  overlapping", triangle.h comment)

The brute-force path scans triangles in fixed-size chunks via ``lax.scan``
so peak memory is O(rays * tri_chunk), with a running (best_t, best_i, ...)
carry in place of the reference's per-ray loop.

Precision: every contraction here runs at ``Precision.HIGHEST``. A float32
contraction left at default precision may run in TF32 on a GPU, whose
~1e-3 relative error exceeds both t_min (5e-4) and tie_eps (4e-6).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.models.scene import Scene

INF = jnp.float32(3.0e38)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Hit:
    """Per-ray closest-hit record (the reference's HitRecord, bvh.h:7-15)."""

    t: jax.Array        # (R,) distance, INF on miss
    idx: jax.Array      # (R,) int32 triangle index, 0 on miss (mask with .hit)
    u: jax.Array        # (R,) barycentric weight of v1
    v: jax.Array        # (R,) barycentric weight of v2
    hit: jax.Array      # (R,) bool

    @property
    def w(self):
        return 1.0 - self.u - self.v


def _pad_to(x, multiple, axis=0, value=0):
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return jnp.pad(x, pad, constant_values=value)


def moller_trumbore(org, d, v0, v1, v2, gn, config: RenderConfig):
    """Intersect R rays against C triangles -> (t, u, v, ok) each (R, C).

    org/d: (R, 3); v0/v1/v2/gn: (C, 3).
    """
    # HIGHEST: a float32 contraction may otherwise run in TF32 on a GPU
    hp = jax.lax.Precision.HIGHEST
    e1 = v1 - v0                                    # (C, 3)
    e2 = v2 - v0
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])  # (R, C, 3)
    det = jnp.einsum("cj,rcj->rc", e1, pvec, precision=hp)
    inv_det = jnp.reciprocal(jnp.where(det == 0.0, 1.0, det))
    tvec = org[:, None, :] - v0[None, :, :]
    u = jnp.einsum("rcj,rcj->rc", tvec, pvec, precision=hp) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.einsum("rj,rcj->rc", d, qvec, precision=hp) * inv_det
    t = jnp.einsum("cj,rcj->rc", e2, qvec, precision=hp) * inv_det

    # reference acceptance: grazing cull against the *unit* geometric normal
    # (bvh.cpp:185) + t_min (bvh.cpp:189) + inside test.
    ndd = jnp.dot(d, gn.T, precision=hp)            # (R, C)
    ok = (
        (jnp.abs(ndd) >= config.n_dot_d_min)
        & (det != 0.0)
        & (t >= config.t_min)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
    )
    return t, u, v, ok


def _chunk_best(t, u, v, ok, emissive, tie_eps):
    """Per-ray best over the chunk axis with emissive tie preference.

    "Equal distance" (reference bvh.cpp:219) is a RELATIVE band of width
    tie_eps, not exact float equality — see config.tie_eps.
    t/u/v/ok: (R, C); emissive: (C,) -> (bt, bi, bu, bv, bemis) each (R,).
    """
    tm = jnp.where(ok, t, INF)
    bt = jnp.min(tm, axis=1)
    tie_emis = (
        (tm <= bt[:, None] * (1.0 + tie_eps))
        & (tm < INF)
        & emissive[None, :]
    )
    has_emis = jnp.any(tie_emis, axis=1)
    bi = jnp.where(has_emis, jnp.argmax(tie_emis, axis=1), jnp.argmin(tm, axis=1))
    take = lambda a: jnp.take_along_axis(a, bi[:, None], axis=1)[:, 0]
    return take(tm), bi.astype(jnp.int32), take(u), take(v), has_emis


def _merge_best(carry, cand, tie_eps):
    """Merge a chunk's best into the running best: strictly-closer wins
    outside the tie band; inside the band an emissive candidate displaces a
    non-emissive incumbent (reference bvh.cpp:168-174,219)."""
    bt0, bi0, bu0, bv0, be0 = carry
    bt, bi, bu, bv, be = cand
    near = (bt <= bt0 * (1.0 + tie_eps)) & (bt0 <= bt * (1.0 + tie_eps)) & (bt < INF)
    repl = (~near & (bt < bt0)) | (near & be & ~be0)
    sel = lambda a, b: jnp.where(repl, a, b)
    return (sel(bt, bt0), sel(bi, bi0), sel(bu, bu0), sel(bv, bv0), sel(be, be0))


def brute_force_intersect(scene: Scene, org, d, config: RenderConfig) -> Hit:
    """Closest hit over all triangles, scanned in chunks of config.tri_chunk."""
    C = config.tri_chunk
    T = scene.v0.shape[0]
    n_chunks = -(-T // C)

    # pad with degenerate triangles: gn = 0 fails the 1e-5 grazing cull so
    # padding can never be hit.
    stack = lambda a, value=0.0: _pad_to(a, C, value=value).reshape(
        n_chunks, C, *a.shape[1:]
    )
    xs = (
        stack(scene.v0),
        stack(scene.v1),
        stack(scene.v2),
        stack(scene.gn),
        stack(scene.tri_emissive, value=False),
        _pad_to(
            jnp.arange(T, dtype=jnp.int32), C, value=0
        ).reshape(n_chunks, C),
    )

    R = org.shape[0]
    init = (
        jnp.full((R,), INF),
        jnp.zeros((R,), jnp.int32),
        jnp.zeros((R,)),
        jnp.zeros((R,)),
        jnp.zeros((R,), bool),
    )

    def body(carry, chunk):
        v0, v1, v2, gn, emis, tid = chunk
        t, u, v, ok = moller_trumbore(org, d, v0, v1, v2, gn, config)
        bt, bi, bu, bv, be = _chunk_best(t, u, v, ok, emis, config.tie_eps)
        return _merge_best(carry, (bt, tid[bi], bu, bv, be), config.tie_eps), None

    (bt, bi, bu, bv, _), _ = jax.lax.scan(body, init, xs)
    return Hit(t=bt, idx=bi, u=bu, v=bv, hit=bt < INF)


def mxu_intersect(scene: Scene, org, d, config: RenderConfig) -> Hit:
    """Closest hit over all triangles with the intersection test phrased as
    MATMULS instead of per-triangle cross products.

    Uses the per-triangle Woop transform precomputed at scene build
    (models/scene.py woop_transform): local-space ray is LINEAR in
    (origin, direction), so for a chunk of C triangles

        ld = d   @ A^T            (R,3) x (3, 3C)  matmul
        lo = org @ A^T + b        (R,3) x (3, 3C)  matmul (+broadcast bias)
        t  = -lo_z / ld_z ;  u = lo_x + t*ld_x ;  v = lo_y + t*ld_y

    The grazing cull |dot(gn, d)| >= 1e-5 (reference bvh.cpp:185) rides the
    same matmul as 3 extra rows: ~21 matmul FLOPs per ray-triangle pair vs
    ~60 elementwise FLOPs for classic Moller-Trumbore. float32 precision is
    forced with Precision.HIGHEST (geometry at Cornell-box scale breaks
    under bf16 or TF32 matmul rounding).
    """
    C = config.tri_chunk
    T = scene.v0.shape[0]
    n_chunks = -(-T // C)
    R = org.shape[0]

    # BLOCK-ordered rows per chunk: [C u-rows | C v-rows | C w-rows]. The
    # matmul output (R, 3C) then yields the u/v/w planes as CONTIGUOUS
    # (R, C) slices — no (R, C, 3) reshape with a minor dimension of 3.
    # Zero padding rows can never produce a valid hit: ld_w = 0 -> t = inf.
    pad3 = lambda x: _pad_to(x, C).reshape(n_chunks, C, 3)
    A = jnp.concatenate(
        [pad3(scene.woop_a[:, 0]), pad3(scene.woop_a[:, 1]), pad3(scene.woop_a[:, 2])],
        axis=1,
    )                                                     # (n_chunks, 3C, 3)
    pad1 = lambda x: _pad_to(x, C).reshape(n_chunks, C)
    B = jnp.concatenate(
        [pad1(scene.woop_b[:, 0]), pad1(scene.woop_b[:, 1]), pad1(scene.woop_b[:, 2])],
        axis=1,
    )                                                     # (n_chunks, 3C)
    G = _pad_to(scene.gn, C).reshape(n_chunks, C, 3)
    emis = _pad_to(scene.tri_emissive, C, value=False).reshape(n_chunks, C)
    tid = _pad_to(jnp.arange(T, dtype=jnp.int32), C).reshape(n_chunks, C)

    org4 = org
    hp = jax.lax.Precision.HIGHEST

    init = (
        jnp.full((R,), INF),
        jnp.zeros((R,), jnp.int32),
        jnp.zeros((R,)),
        jnp.zeros((R,)),
        jnp.zeros((R,), bool),
    )

    def body(carry, chunk):
        a, b, g, em, ids = chunk
        ld = jnp.dot(d, a.T, precision=hp)                   # (R, 3C)
        lo = jnp.dot(org4, a.T, precision=hp) + b[None, :]   # (R, 3C)
        ndd = jnp.dot(d, g.T, precision=hp)                  # (R, C)

        ldz = ld[:, 2 * C :]
        inv = jnp.reciprocal(jnp.where(ldz == 0.0, 1.0, ldz))
        t = -lo[:, 2 * C :] * inv
        u = lo[:, :C] + t * ld[:, :C]
        v = lo[:, C : 2 * C] + t * ld[:, C : 2 * C]
        ok = (
            (jnp.abs(ndd) >= config.n_dot_d_min)
            & (ldz != 0.0)
            & (t >= config.t_min)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
        )
        t = jnp.where(ok, t, INF)
        bt, bi, bu, bv, be = _chunk_best(t, u, v, ok, em, config.tie_eps)
        return _merge_best(carry, (bt, ids[bi], bu, bv, be), config.tie_eps), None

    (bt, bi, bu, bv, _), _ = jax.lax.scan(body, init, (A, B, G, emis, tid))
    return Hit(t=bt, idx=bi, u=bu, v=bv, hit=bt < INF)


def intersect(scene: Scene, org, d, config: RenderConfig, t_bound=None) -> Hit:
    """Dispatch to the configured intersector.

    "auto" resolves to the while-loop BVH walk when a BVH is attached,
    otherwise to the mxu matmul intersector. ``t_bound`` (optional (R,))
    lets the BVH walk start at each ray's bound (ops/traverse.py); the
    brute-force intersectors ignore it — callers that pass a bound apply
    it to the result themselves (ops/trace.py).
    """
    backend = config.intersector
    if backend == "auto":
        backend = "bvh" if scene.bvh is not None else "mxu"
    if backend == "mxu":
        return mxu_intersect(scene, org, d, config)
    if backend == "brute":
        return brute_force_intersect(scene, org, d, config)
    if backend == "bvh":
        from tinyraytracing_tpu.ops.traverse import bvh_intersect

        if scene.bvh is None:
            raise ValueError("scene has no BVH; call ops.bvh.attach_bvh first")
        return bvh_intersect(scene, org, d, config, t_bound=t_bound)
    raise ValueError(f"unknown intersector {backend!r}")
