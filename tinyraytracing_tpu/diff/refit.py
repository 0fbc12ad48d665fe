"""BVH refit under vertex moves (differentiable-render support).

Vertex offsets keep the tree TOPOLOGY valid — only the boxes go stale — so
this module REFITS them inside jit instead of dropping the BVH:

- leaf boxes: segment min/max of the moved per-triangle AABBs over
  ``BVHArrays.tri_leaf`` (builder pad ±aabb_pad applied, bvh.cpp:31-40);
- interior boxes: bottom-up union over ``n_levels`` vectorized sweeps
  (children's padded union == subtree box ± pad, so the propagated boxes
  equal a from-scratch build of the same topology).

The trace reads triangles straight from the scene's (moved) arrays, so the
boxes are all that needs refitting.

Everything is wrapped in stop_gradient by the caller: hit-finding is
discrete; gradients come from the custom-VJP path replay (diff/fast.py),
which differentiates the closed-form hit point of the FOUND triangle.

A refitted tree can be of lower quality than a rebuild (boxes may
overlap more after large moves) — correctness is unaffected (boxes
always bound their triangles); callers doing large deformations should
re-attach periodically.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def refit_bvh(scene, aabb_pad: float | None = None):
    """Return ``scene`` with its BVH boxes refit to the CURRENT v0/v1/v2
    arrays. ``aabb_pad`` defaults to the pad the BUILDER recorded on the
    tree (BVHArrays.aabb_pad) so refit boxes match a from-scratch build
    even under a non-default config.aabb_pad."""
    bvh = scene.bvh
    if bvh.tri_leaf is None:
        raise ValueError("scene.bvh lacks refit metadata (re-attach_bvh)")
    if aabb_pad is None:
        aabb_pad = bvh.aabb_pad
    N = bvh.n_nodes

    tmin = jnp.minimum(jnp.minimum(scene.v0, scene.v1), scene.v2)
    tmax = jnp.maximum(jnp.maximum(scene.v0, scene.v1), scene.v2)
    leaf_min = jax.ops.segment_min(tmin, bvh.tri_leaf, num_segments=N)
    leaf_max = jax.ops.segment_max(tmax, bvh.tri_leaf, num_segments=N)
    is_leaf = (bvh.count > 0)[:, None]
    big = jnp.float32(3e38)
    nmin = jnp.where(is_leaf, leaf_min - aabb_pad, big)
    nmax = jnp.where(is_leaf, leaf_max + aabb_pad, -big)

    cl = jnp.maximum(bvh.child_l, 0)
    cr = jnp.maximum(bvh.child_r, 0)
    internal = (bvh.count == 0)[:, None]
    for lvl in range(bvh.n_levels - 2, -1, -1):
        m = internal & (bvh.level == lvl)[:, None]
        nmin = jnp.where(m, jnp.minimum(nmin[cl], nmin[cr]), nmin)
        nmax = jnp.where(m, jnp.maximum(nmax[cl], nmax[cr]), nmax)

    bvh2 = dataclasses.replace(bvh, nmin=nmin, nmax=nmax)
    return dataclasses.replace(scene, bvh=bvh2)
