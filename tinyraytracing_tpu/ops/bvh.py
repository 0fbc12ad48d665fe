"""SAH BVH construction (host side) → flattened stackless device layout.

Split semantics replicate the reference builder (RayTracingOnCPU/
bvh.cpp:16-144): top-down over centroid-sorted ranges, full-sweep SAH on all
3 axes with cost = surface_area * count on both sides for every split
position, leaf when <= leaf_size (reference default 8, main.cpp:76), node
AABBs padded by ±1e-3 (bvh.cpp:31-40). Where the reference re-sorts the
subrange 3(+1) times per node (bvh.cpp:56-60,133-138 — O(N log^2 N)), we
pre-sort once per axis and maintain the three orderings by stable partition
(the classic O(N log N) sweep) — the chosen splits are identical.

The pointer tree (bvh.h:16-22) is flattened to depth-first preorder SoA
arrays with **skip links**: node i's subtree occupies [i, skip[i]); an
internal node's left child is i+1. Traversal then needs no stack — a single
``while`` over a node cursor: descend (i+1) on AABB hit, jump to skip[i]
otherwise (ops/traverse.py). The same arrays serve a stack walk (the CUDA
trace, ops/trace_kernel.cu): the right child of internal node i is
skip[i+1].

Triangles are permuted so every leaf's range is contiguous (the reference
instead sorts its global triangle vector in place during the build).
"""

from __future__ import annotations

import numpy as np

from tinyraytracing_tpu.config import RenderConfig


def build_bvh(
    tri_v: np.ndarray, leaf_size: int = 8, aabb_pad: float = 1e-3
) -> tuple[dict, np.ndarray]:
    """Build from (T, 3, 3) float vertices.

    Returns (nodes dict of numpy arrays {nmin,nmax,start,count,skip},
    permutation (T,) such that leaf ranges index permuted triangles).
    """
    tri_v = np.asarray(tri_v, dtype=np.float64)
    T = tri_v.shape[0]
    tmin = tri_v.min(axis=1)                      # (T, 3) per-tri AABB
    tmax = tri_v.max(axis=1)
    centers = tri_v.mean(axis=1)                  # reference centroid (scene.cpp:197)

    # three axis orderings of the full set, maintained by stable partition
    lists = [np.argsort(centers[:, a], kind="stable") for a in range(3)]

    nmin_l: list = []
    nmax_l: list = []
    start_l: list = []
    count_l: list = []
    skip_l: list = []
    perm_chunks: list = []
    perm_offset = 0

    # explicit stack of (ids_by_axis, phase); phase "post" entries patch skip
    stack: list = [(lists, False, None)]
    while stack:
        item = stack.pop()
        if item[1]:  # post-visit: set skip to the next emitted node index
            skip_l[item[2]] = len(nmin_l)
            continue
        ids3, _, _ = item
        ids0 = ids3[0]
        n = len(ids0)
        node = len(nmin_l)
        nmin_l.append(tmin[ids0].min(axis=0) - aabb_pad)
        nmax_l.append(tmax[ids0].max(axis=0) + aabb_pad)
        skip_l.append(-1)
        stack.append((None, True, node))

        if n <= leaf_size:
            nonlocal_start = perm_offset
            perm_chunks.append(ids0)
            perm_offset += n
            start_l.append(nonlocal_start)
            count_l.append(n)
            continue
        start_l.append(0)
        count_l.append(0)

        # full-sweep SAH over all 3 axes (reference bvh.cpp:52-131)
        best_cost = np.inf
        best_axis = 0
        best_split = n // 2
        for a in range(3):
            ids = ids3[a]
            lo = tmin[ids]                         # (n, 3) in axis order
            hi = tmax[ids]
            pre_min = np.minimum.accumulate(lo, axis=0)
            pre_max = np.maximum.accumulate(hi, axis=0)
            suf_min = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(hi[::-1], axis=0)[::-1]

            def sa(mn, mx):
                d = mx - mn
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2])

            left_sa = sa(pre_min[:-1], pre_max[:-1])        # split after i
            right_sa = sa(suf_min[1:], suf_max[1:])
            counts = np.arange(1, n)
            cost = left_sa * counts + right_sa * (n - counts)
            i = int(np.argmin(cost))
            if cost[i] < best_cost:
                best_cost = cost[i]
                best_axis = a
                best_split = i                     # left = [0..i] of this axis order

        left_ids = ids3[best_axis][: best_split + 1]
        member = np.zeros(T, dtype=bool)
        member[left_ids] = True
        left3 = []
        right3 = []
        for a in range(3):
            ids = ids3[a]
            m = member[ids]
            left3.append(ids[m])
            right3.append(ids[~m])
        # preorder: left subtree first -> push right, then left
        stack.append((right3, False, None))
        stack.append((left3, False, None))

    perm = np.concatenate(perm_chunks) if perm_chunks else np.arange(0)
    nodes = dict(
        nmin=np.asarray(nmin_l, dtype=np.float32),
        nmax=np.asarray(nmax_l, dtype=np.float32),
        start=np.asarray(start_l, dtype=np.int32),
        count=np.asarray(count_l, dtype=np.int32),
        skip=np.asarray(skip_l, dtype=np.int32),
    )
    return nodes, perm.astype(np.int64)


def build_bvh_host(
    tri_v: np.ndarray, leaf_size: int = 8, aabb_pad: float = 1e-3
) -> tuple[dict, np.ndarray]:
    """Builder dispatch: native C++ builder when available, else numpy.
    Returns (nodes dict incl. 'leaf_size', permutation)."""
    try:
        from tinyraytracing_tpu.native import build_bvh_native

        nodes, perm = build_bvh_native(np.asarray(tri_v), leaf_size, aabb_pad)
    except ImportError:
        nodes, perm = build_bvh(np.asarray(tri_v), leaf_size, aabb_pad)
    nodes["leaf_size"] = leaf_size
    nodes["aabb_pad"] = aabb_pad
    return nodes, perm


def bvh_arrays(nodes: dict, leaf_size: int, aabb_pad: float):
    """Device BVHArrays from a host build, with the static topology the
    refit pass (diff/refit.py) and the CUDA trace's stack bound need."""
    import jax.numpy as jnp

    from tinyraytracing_tpu.models.scene import BVHArrays

    count_np = np.asarray(nodes["count"])
    skip_np = np.asarray(nodes["skip"])
    N = len(count_np)
    tri_leaf = np.zeros(int(count_np.sum()), np.int32)
    for i in np.nonzero(count_np > 0)[0]:
        s0 = int(nodes["start"][i])
        tri_leaf[s0:s0 + int(count_np[i])] = i
    level = np.zeros(N, np.int32)
    child_l = np.full(N, -1, np.int32)
    child_r = np.full(N, -1, np.int32)
    for i in np.nonzero(count_np == 0)[0]:
        l, r = i + 1, int(skip_np[i + 1])
        child_l[i], child_r[i] = l, r
        level[l] = level[i] + 1
        level[r] = level[i] + 1
    return BVHArrays(
        nmin=jnp.asarray(nodes["nmin"]),
        nmax=jnp.asarray(nodes["nmax"]),
        start=jnp.asarray(nodes["start"]),
        count=jnp.asarray(nodes["count"]),
        skip=jnp.asarray(nodes["skip"]),
        n_nodes=int(N),
        leaf_size=int(leaf_size),
        tri_leaf=jnp.asarray(tri_leaf),
        level=jnp.asarray(level),
        child_l=jnp.asarray(child_l),
        child_r=jnp.asarray(child_r),
        n_levels=int(level.max()) + 1 if N else 1,
        aabb_pad=float(aabb_pad),
    )


def attach_bvh(scene, config: RenderConfig):
    """Build a BVH for ``scene`` and return a new Scene with (a) triangles
    permuted to leaf order and (b) scene.bvh set.

    NOTE: pulls geometry back to host — load_scene(with_bvh=True) builds
    before upload instead."""
    import dataclasses

    import jax.numpy as jnp

    v = np.stack(
        [np.asarray(scene.v0), np.asarray(scene.v1), np.asarray(scene.v2)], axis=1
    )
    nodes, perm = build_bvh_host(v, config.leaf_size, config.aabb_pad)
    bvh = bvh_arrays(nodes, config.leaf_size, config.aabb_pad)
    permute = lambda a: jnp.asarray(np.asarray(a)[perm])
    inv_perm = np.empty(len(perm), np.int64)
    inv_perm[np.asarray(perm)] = np.arange(len(perm))
    return dataclasses.replace(
        scene,
        v0=permute(scene.v0), v1=permute(scene.v1), v2=permute(scene.v2),
        n0=permute(scene.n0), n1=permute(scene.n1), n2=permute(scene.n2),
        t0=permute(scene.t0), t1=permute(scene.t1), t2=permute(scene.t2),
        gn=permute(scene.gn),
        woop_a=permute(scene.woop_a),
        woop_b=permute(scene.woop_b),
        tri_mtl=permute(scene.tri_mtl),
        tri_emissive=permute(scene.tri_emissive),
        lt_tri=jnp.asarray(inv_perm[np.asarray(scene.lt_tri)].astype(np.int32)),
        bvh=bvh,
    )
