"""Stackless BVH traversal as a vmapped ``lax.while_loop``.

Replaces the reference's recursive two-child descent (RayTracingOnCPU/
bvh.cpp:146-175) with a single node cursor over the preorder skip-link
layout (ops/bvh.py): AABB hit on an internal node -> cursor+1 (descend into
left child); miss or finished leaf -> cursor = skip[cursor].

Improvements over the reference, result-equivalent:
- early-out pruning: a node is skipped when its AABB entry distance exceeds
  the current best hit (the reference explores both children regardless,
  bvh.cpp:156-166); the comparison is <= so equal-distance emissive
  tie-breaks (bvh.cpp:219) still see their candidates.
- leaf triangles are tested as one masked vector batch of ``leaf_size``
  (Möller–Trumbore, ops/intersect.py) instead of a scalar loop with a per-hit
  Eigen QR solve (bvh.cpp:211-229).
- optional per-ray start bound ``t_bound``: the walk starts with best t at
  the bound, so nodes beyond it are pruned from the first visit. The first
  hit is admitted iff t <= t_bound * (1 + tie_eps) and the usual rule
  applies after it, so every hit within the band of the bound is found
  exactly as an unbounded walk finds it (shadow rays pass the light
  distance; ops/trace.py).

Slab test per the reference interactAABB (bvh.cpp:231-245): entry t0 when
outside, exit t1 when inside; a box "hits" when t1 >= t0 and the returned
distance is > 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.ops.intersect import INF, Hit, moller_trumbore


def bvh_intersect(scene, org, d, config: RenderConfig, t_bound=None) -> Hit:
    bvh = scene.bvh
    LS = bvh.leaf_size
    N = bvh.n_nodes
    T = scene.v0.shape[0]
    lane = jnp.arange(LS)
    eps = config.tie_eps
    if t_bound is None:
        t_bound = jnp.full(org.shape[:1], INF)

    def one_ray(o, dd, tb):
        inv = jnp.reciprocal(jnp.where(dd == 0.0, 1e-30, dd))

        def cond(s):
            return s[0] < N

        def body(s):
            node, bt, bi, bu, bv, be = s
            t_a = (bvh.nmin[node] - o) * inv
            t_b = (bvh.nmax[node] - o) * inv
            t0 = jnp.max(jnp.minimum(t_a, t_b))
            t1 = jnp.min(jnp.maximum(t_a, t_b))
            dist = jnp.where(t0 > 0.0, t0, t1)
            aabb_hit = (t1 >= t0) & (dist > 0.0)
            if config.bvh_early_out:
                aabb_hit = aabb_hit & (
                    jnp.maximum(t0, 0.0) <= bt * (1.0 + config.tie_eps)
                )

            count = bvh.count[node]
            is_leaf = count > 0

            # masked vector test of the leaf's <= LS triangles
            ids = jnp.clip(bvh.start[node] + lane, 0, T - 1)
            mask = (lane < count) & aabb_hit & is_leaf
            t, u, v, ok = moller_trumbore(
                o[None, :], dd[None, :],
                scene.v0[ids], scene.v1[ids], scene.v2[ids], scene.gn[ids],
                config,
            )
            ok = ok[0] & mask
            t = jnp.where(ok, t[0], INF)
            emis = scene.tri_emissive[ids] & ok

            lt = jnp.min(t)
            # epsilon-banded emissive tie preference (see config.tie_eps)
            tie = (t <= lt * (1.0 + config.tie_eps)) & (t < INF) & emis
            lhas = jnp.any(tie)
            li = jnp.where(lhas, jnp.argmax(tie), jnp.argmin(t))
            lt = t[li]
            near = (lt <= bt * (1.0 + eps)) & (bt <= lt * (1.0 + eps)) & (
                lt < INF
            )
            repl = jnp.where(
                bi < 0,
                (lt < INF) & (lt <= tb * (1.0 + eps)),   # first admitted hit
                (~near & (lt < bt)) | (near & lhas & ~be),
            )
            bt = jnp.where(repl, lt, bt)
            bi = jnp.where(repl, ids[li].astype(jnp.int32), bi)
            bu = jnp.where(repl, u[0, li], bu)
            bv = jnp.where(repl, v[0, li], bv)
            be = jnp.where(repl, lhas, be)

            nxt = jnp.where(aabb_hit & ~is_leaf, node + 1, bvh.skip[node])
            return (nxt, bt, bi, bu, bv, be)

        init = (
            jnp.int32(0), tb, jnp.int32(-1),
            jnp.float32(0), jnp.float32(0), False,
        )
        _, bt, bi, bu, bv, _ = jax.lax.while_loop(cond, body, init)
        return bt, bi, bu, bv

    bt, bi, bu, bv = jax.vmap(one_ray)(org, d, t_bound)
    hit = bi >= 0
    return Hit(t=jnp.where(hit, bt, INF), idx=jnp.maximum(bi, 0), u=bu, v=bv,
               hit=hit)
