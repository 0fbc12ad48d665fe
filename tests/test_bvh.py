"""BVH build invariants: leaf ranges partition the triangle set, skip links
form a valid preorder threading, node AABBs contain their triangles with the
reference's 1e-3 pad (bvh.cpp:31-40), SAH splits respect leaf_size
(main.cpp:76)."""

import numpy as np
import pytest

from tinyraytracing_tpu.ops.bvh import build_bvh


@pytest.fixture(scope="module")
def built(rng):
    v = rng.uniform(0, 100, (500, 3, 3))
    nodes, perm = build_bvh(v, leaf_size=8, aabb_pad=1e-3)
    return v, nodes, perm


def test_permutation_valid(built):
    v, nodes, perm = built
    assert sorted(perm.tolist()) == list(range(len(v)))


def test_leaves_partition(built):
    v, nodes, perm = built
    leaf = nodes["count"] > 0
    starts = nodes["start"][leaf]
    counts = nodes["count"][leaf]
    order = np.argsort(starts)
    starts, counts = starts[order], counts[order]
    assert starts[0] == 0
    assert np.all(starts[1:] == starts[:-1] + counts[:-1])
    assert starts[-1] + counts[-1] == len(v)
    assert counts.max() <= 8


def test_skip_links_preorder(built):
    v, nodes, perm = built
    N = len(nodes["skip"])
    skip = nodes["skip"]
    assert np.all(skip > np.arange(N))
    assert np.all(skip <= N)
    # walking hit-path (i+1 for internal, skip for leaf) visits every node
    visited = 0
    i = 0
    seen_leaf_tris = 0
    while i < N:
        visited += 1
        if nodes["count"][i] > 0:
            seen_leaf_tris += nodes["count"][i]
            i = skip[i]
        else:
            i += 1
    assert visited == N
    assert seen_leaf_tris == len(v)


def test_aabbs_contain_triangles(built):
    v, nodes, perm = built
    pv = v[perm]
    leaf = np.nonzero(nodes["count"] > 0)[0]
    for li in leaf[:50]:
        s, c = nodes["start"][li], nodes["count"][li]
        tri = pv[s : s + c]
        assert np.all(tri.min(axis=(0, 1)) >= nodes["nmin"][li] - 1e-5)
        assert np.all(tri.max(axis=(0, 1)) <= nodes["nmax"][li] + 1e-5)
    # root contains everything
    assert np.all(v.min(axis=(0, 1)) >= nodes["nmin"][0] - 1e-5)
    assert np.all(v.max(axis=(0, 1)) <= nodes["nmax"][0] + 1e-5)


def test_single_triangle_and_tiny_scenes():
    v = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], dtype=np.float64)
    nodes, perm = build_bvh(v)
    assert len(nodes["nmin"]) == 1 and nodes["count"][0] == 1
    v9 = np.repeat(v, 9, axis=0) + np.arange(9)[:, None, None]
    nodes, perm = build_bvh(v9, leaf_size=8)
    assert (nodes["count"] > 0).sum() == 2  # must split: 9 > 8


def test_bvh_arrays_topology():
    """bvh_arrays' static topology (used by the refit and by the CUDA
    trace's stack bound): children are i+1 and skip[i+1], levels count
    depth from the root, every triangle maps to the leaf that holds it."""
    from tinyraytracing_tpu.ops.bvh import build_bvh, bvh_arrays

    rng = np.random.default_rng(5)
    tri = rng.uniform(0, 10, (300, 3, 3))
    nodes, _perm = build_bvh(tri, leaf_size=4)
    b = bvh_arrays(nodes, 4, 1e-3)
    count, skip, start = nodes["count"], nodes["skip"], nodes["start"]
    level = np.asarray(b.level)
    for i in range(len(count)):
        if count[i] == 0:
            assert b.child_l[i] == i + 1 and b.child_r[i] == skip[i + 1]
            assert level[i + 1] == level[skip[i + 1]] == level[i] + 1
        else:
            ids = np.asarray(b.tri_leaf)[start[i]:start[i] + count[i]]
            assert (ids == i).all()
    assert b.n_levels == level.max() + 1 and level[0] == 0
