"""The trace (ops/trace.py): dispatch, the plain path, the CUDA kernel's
wrapper, the custom-VJP rule around it, gather-free lookups
(ops/lookup.py) and the fused renderers (integrator/fused*.py).

The trace's contract: the hit set of the reference acceptance rules
(RayTracingOnCPU/bvh.cpp:146-229) — checked against the brute-force
intersector, which shares no traversal code with the BVH walk — and the
barycentric-interpolated shading attributes of the hit triangle. The CUDA
kernel itself has no CPU mode: the test that runs it is marked ``gpu`` and
skips here (chip_smoke.py phase 4 runs the same comparison on the card);
everything around the library call is tested here with the call stubbed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.ops import trace as trace_mod
from tinyraytracing_tpu.ops import trace_cuda
from tinyraytracing_tpu.ops.intersect import brute_force_intersect
from tinyraytracing_tpu.ops.lookup import chain_lookup, chain_lookup_planes
from tinyraytracing_tpu.ops.trace import fused_trace_planes

CFG = RenderConfig(intersector="bvh")


def _rays(rng, n, center=(0.0, 0.5, 2.0), spread=0.2):
    org = rng.uniform(-1, 1, (n, 3)) * spread + np.asarray(center)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32)


def _box_rays(rng, n):
    """Rays from inside and in front of the cornell box, any direction."""
    org = rng.uniform([0, 0, -400], [556, 548, 559], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32)


def _planes(org, d):
    return (org[:, 0], org[:, 1], org[:, 2], d[:, 0], d[:, 1], d[:, 2])


def _reference_attrs(scene, hit):
    """Shading attributes gathered from an independent hit record."""
    idx = np.asarray(hit.idx)
    u = np.asarray(hit.u)
    v = np.asarray(hit.v)
    w = 1.0 - u - v
    interp = lambda a, b, c: (
        np.asarray(a)[idx] * w[:, None]
        + np.asarray(b)[idx] * u[:, None]
        + np.asarray(c)[idx] * v[:, None]
    )
    return dict(
        pn=interp(scene.n0, scene.n1, scene.n2),
        tc=interp(scene.t0, scene.t1, scene.t2)[:, :2],
        mtl=np.asarray(scene.tri_mtl)[idx],
        em=np.asarray(scene.tri_emissive)[idx],
    )


def _check_fused(scene, org, d, cfg):
    """The dispatched (plain) trace against the brute-force intersector."""
    hit = brute_force_intersect(scene, org, d, cfg)
    t, pnx, pny, pnz, tcu, tcv, mtl, em = fused_trace_planes(
        scene, *_planes(org, d), cfg
    )
    t_ref = np.asarray(hit.t)
    t_new = np.asarray(t)
    h = np.asarray(hit.hit)
    assert np.array_equal(h, np.asarray(mtl) >= 0), "hit sets differ"
    np.testing.assert_allclose(t_new[h], t_ref[h], rtol=1e-5, atol=1e-6)

    ref = _reference_attrs(scene, hit)
    pn_new = np.stack([pnx, pny, pnz], -1)
    tc_new = np.stack([tcu, tcv], -1)
    np.testing.assert_allclose(pn_new[h], ref["pn"][h], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc_new[h], ref["tc"][h], rtol=1e-4, atol=1e-4)
    assert np.array_equal(np.asarray(mtl)[h].astype(np.int32), ref["mtl"][h])
    assert np.array_equal(np.asarray(em)[h] > 0.5, ref["em"][h])


def test_fused_trace_matches_gather_path(test_scene_bvh, rng):
    scene, _ = test_scene_bvh
    org, d = _box_rays(rng, 512)
    _check_fused(scene, org, d, CFG)


def _light_queries(scene, rng, n):
    """Genuine shadow-style queries: origins in the box, directions at a
    sampled point on light 0, bound = that distance, target = the light's
    material (planar light: the kill/seen decomposition is exact)."""
    org = rng.uniform([1, 1, 1], [555, 547, 558], (n, 3))
    lv = [np.asarray(tab[0, 0], np.float64)
          for tab in (scene.lt_v0, scene.lt_v1, scene.lt_v2)]
    b = rng.uniform(0, 1, (n, 3))
    b /= b.sum(1, keepdims=True)
    lp = b[:, :1] * lv[0] + b[:, 1:2] * lv[1] + b[:, 2:] * lv[2]
    to_l = lp - org
    tb = np.linalg.norm(to_l, axis=1)
    d = jnp.asarray(to_l / tb[:, None], jnp.float32)
    tg = jnp.full((n,), float(scene.light_mtl[0]), jnp.float32)
    return jnp.asarray(org, jnp.float32), d, jnp.asarray(tb, jnp.float32), tg


def test_fused_trace_kill_with_return_tri(test_scene_bvh, rng):
    """Target-material kill combined with return_tri/attrs, against the
    closest-hit decomposition computed from the brute-force intersector:
    killed lanes (closest hit of another material strictly inside the
    band of the bound) report exactly (t=-1, mtl=-3, em=0, tri=-1) — a
    stale triangle on a killed lane would make the diff path replay
    gradients for a hit the forward reported as occluded. pn/tc of killed
    lanes are undefined by contract and not compared."""
    scene, _ = test_scene_bvh
    n = 384
    org, d, tb, tg = _light_queries(scene, rng, n)
    out = fused_trace_planes(scene, *_planes(org, d), CFG, t_bound=tb,
                             target_mtl=tg, return_tri=True)
    hit = brute_force_intersect(scene, org, d, CFG)
    eps = CFG.tie_eps
    t_ref, h = np.asarray(hit.t), np.asarray(hit.hit)
    mtl_ref = np.asarray(scene.tri_mtl)[np.asarray(hit.idx)].astype(np.float32)
    tb_np, tg_np = np.asarray(tb), np.asarray(tg)
    inside = h & (t_ref * (1 + eps) < tb_np)
    killed = inside & (mtl_ref != tg_np)
    assert killed.any() and (~killed).any(), "test did not exercise both"
    np.testing.assert_array_equal(np.asarray(out[6]) == -3.0, killed)
    for i, sentinel in ((0, -1.0), (7, 0.0), (8, -1.0)):
        np.testing.assert_array_equal(
            np.asarray(out[i])[killed], np.full(killed.sum(), sentinel)
        )
    # surviving lanes: visible exactly where the closest hit is the light
    live = ~killed
    seen = h & (np.abs(mtl_ref - tg_np) <= 0.5) & (t_ref <= tb_np * (1 + eps))
    np.testing.assert_array_equal((np.asarray(out[6]) == tg_np)[live], seen[live])
    vis = live & seen
    np.testing.assert_allclose(np.asarray(out[0])[vis], t_ref[vis], rtol=1e-5)


def test_occlusion_query_matches_closest_hit_visibility(test_scene_bvh, rng):
    """query="occlusion" must agree with the closest-hit trace's
    material-equality visibility on genuine shadow queries, for the BVH
    walk and for the brute-force intersector."""
    scene, _ = test_scene_bvh
    org, d, tb, tg = _light_queries(scene, rng, 384)
    kw = dict(t_bound=tb, target_mtl=tg)
    for cfg in (CFG, CFG.replace(intersector="brute")):
        _, _, _, _, _, _, smtl, _ = fused_trace_planes(
            scene, *_planes(org, d), cfg, attrs=False, **kw
        )
        vis_closest = np.asarray(smtl) == np.asarray(tg)
        assert vis_closest.any() and not vis_closest.all()
        sbt, sseen = fused_trace_planes(
            scene, *_planes(org, d), cfg, query="occlusion", **kw
        )
        vis = (np.asarray(sseen) > 0.5) & (np.asarray(sbt) >= 0.0)
        np.testing.assert_array_equal(vis, vis_closest)


def test_fused_trace_on_cornell_synth(rng):
    from tinyraytracing_tpu.models.procedural import cornell_box
    from tinyraytracing_tpu.ops.bvh import attach_bvh

    scene, cam = cornell_box(width=32, height=32)
    scene = attach_bvh(scene, CFG)
    org, d = _rays(rng, 384, center=(278, 273, -500), spread=100.0)
    _check_fused(scene, org, d, CFG)


@pytest.mark.parametrize("shadow", [False, True])
def test_bounded_walk_matches_unbounded(test_scene_bvh, rng, shadow):
    """The BVH walk started at each ray's bound (ops/traverse.py) resolves
    to exactly what the unbounded walk resolves to: same outputs, bitwise,
    for random bounds (closest-hit queries) and for shadow queries aimed at
    the light."""
    from tinyraytracing_tpu.ops.traverse import bvh_intersect

    scene, _ = test_scene_bvh
    n = 512
    if shadow:
        org, d, tb, tg = _light_queries(scene, rng, n)
    else:
        org, d = _box_rays(rng, n)
        tb = jnp.asarray(rng.uniform(0.0, 900.0, n), jnp.float32)
        tg = jnp.full((n,), -2.0, jnp.float32)

    def resolved(bound):
        hit = bvh_intersect(scene, org, d, CFG, t_bound=bound)
        tri = jnp.where(hit.hit, hit.idx, -1)
        return trace_mod._resolve(scene, hit.t, tri, hit.u, hit.v, tb, tg,
                                  CFG, True)

    for a, b in zip(resolved(tb), resolved(None)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# dispatch and the CUDA kernel's wrapper (library call stubbed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trace,expect", [
    ("auto", False), ("xla", False), ("cuda", RuntimeError),
    ("bogus", ValueError),
])
def test_trace_dispatch(trace, expect):
    """One dispatch point: the plain path on the CPU, an error (never a
    substitute) when the kernel is asked for without a GPU."""
    cfg = RenderConfig(trace=trace)
    if isinstance(expect, bool):
        assert trace_mod.use_kernel(cfg) is expect
    else:
        with pytest.raises(expect):
            trace_mod.use_kernel(cfg)


def test_kernel_trace_raises_without_gpu(test_scene_bvh):
    scene, _ = test_scene_bvh
    z = jnp.zeros((8,), jnp.float32)
    with pytest.raises(RuntimeError, match="GPU"):
        fused_trace_planes(scene, z, z, z, z, z, z + 1.0,
                           RenderConfig(trace="cuda"))


def _unpack(nodes, tris, info):
    """Inverse of trace_cuda.pack_inputs' scene layout."""
    nodes = np.asarray(nodes)
    ints = nodes[:, 6:8].copy().view(np.int32)
    tris = np.asarray(tris)
    info = np.asarray(info)
    return dict(nmin=nodes[:, :3], nmax=nodes[:, 3:6], first=ints[:, 0],
                count=ints[:, 1], v0=tris[:, 0:3], e1=tris[:, 3:6],
                e2=tris[:, 6:9], gn=tris[:, 9:12], mtl=info >> 1,
                em=(info & 1).astype(bool))


def test_pack_inputs_layout(test_scene_bvh, rng):
    """Kernel operands: (8, R) rays, (N, 8) node records (first = leaf
    start or right child skip[i+1], count bit-cast into the last two
    floats), (T, 12) [v0, e1, e2, gn] triangles, material*2+emissive."""
    scene, _ = test_scene_bvh
    org, d = _box_rays(rng, 40)
    tb = jnp.full((40,), 7.0, jnp.float32)
    tg = jnp.full((40,), -2.0, jnp.float32)
    rays, nodes, tris, info = trace_cuda.pack_inputs(
        scene, *_planes(org, d), tb, tg)
    assert rays.shape == (8, 40) and rays.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(rays[3]), np.asarray(d[:, 0]))
    np.testing.assert_array_equal(np.asarray(rays[6]), np.asarray(tb))
    bvh = scene.bvh
    N, T = bvh.n_nodes, scene.num_triangles
    assert nodes.shape == (N, 8) and tris.shape == (T, 12) and info.shape == (T,)
    u = _unpack(nodes, tris, info)
    count, start, skip = (np.asarray(bvh.count), np.asarray(bvh.start),
                          np.asarray(bvh.skip))
    np.testing.assert_array_equal(u["count"], count)
    leaf = count > 0
    np.testing.assert_array_equal(u["first"][leaf], start[leaf])
    inner = np.nonzero(~leaf)[0]
    np.testing.assert_array_equal(u["first"][inner], skip[inner + 1])
    np.testing.assert_array_equal(u["nmin"], np.asarray(bvh.nmin))
    np.testing.assert_array_equal(u["v0"], np.asarray(scene.v0))
    np.testing.assert_array_equal(u["e2"], np.asarray(scene.v2 - scene.v0))
    np.testing.assert_array_equal(u["mtl"], np.asarray(scene.tri_mtl))
    np.testing.assert_array_equal(u["em"], np.asarray(scene.tri_emissive))


def test_pack_inputs_rejects_deep_tree(test_scene_bvh, monkeypatch):
    """A tree deeper than the kernel's fixed stack is refused up front."""
    scene, _ = test_scene_bvh
    monkeypatch.setattr(trace_cuda, "STACK_SIZE", scene.bvh.n_levels - 1)
    z = jnp.zeros((4,), jnp.float32)
    with pytest.raises(ValueError, match="stack"):
        trace_cuda.pack_inputs(scene, z, z, z, z, z, z, z, z)


def _stub_trace_call(rays, nodes, tris, info, *, t_min, graze, tie_eps):
    """Stand-in for the FFI call: the brute-force closest hit computed
    from the PACKED operands alone (so a layout error shows), in the
    kernel's output convention (t = bound on a miss, tri -1)."""
    from tinyraytracing_tpu.ops.intersect import _chunk_best, moller_trumbore

    v0 = tris[:, 0:3]
    org, d = rays[0:3].T, rays[3:6].T
    cfg = RenderConfig(t_min=float(t_min), n_dot_d_min=float(graze),
                       tie_eps=float(tie_eps))
    t, u, v, ok = moller_trumbore(org, d, v0, v0 + tris[:, 3:6],
                                  v0 + tris[:, 6:9], tris[:, 9:12], cfg)
    bt, bi, bu, bv, _ = _chunk_best(t, u, v, ok, (info & 1) > 0, tie_eps)
    hit = bt < 3e38
    return (jnp.where(hit, bt, rays[6]), jnp.where(hit, bi, -1), bu, bv)


@pytest.fixture
def stubbed_kernel(monkeypatch):
    monkeypatch.setattr(trace_mod, "use_kernel", lambda config: True)
    monkeypatch.setattr(trace_cuda, "trace_call", _stub_trace_call)
    jax.clear_caches()
    yield RenderConfig(intersector="brute", trace="cuda")
    jax.clear_caches()


@pytest.mark.parametrize("kw", [
    dict(return_tri=True), dict(attrs=False), dict(query="occlusion"),
])
def test_kernel_wrapper_with_stub(test_scene_bvh, rng, stubbed_kernel, kw):
    """The kernel path's wrapper — operand packing, the hit record, the
    shared resolution and attribute gathers — gives the plain path's
    output planes, shapes and dtypes, for every query form."""
    scene, _ = test_scene_bvh
    n = 300                                  # not a multiple of anything
    if kw.get("query") == "occlusion":
        org, d, tb, tg = _light_queries(scene, rng, n)
        kw = dict(kw, t_bound=tb, target_mtl=tg)
    else:
        org, d = _box_rays(rng, n)
    got = fused_trace_planes(scene, *_planes(org, d), stubbed_kernel, **kw)
    want = fused_trace_planes(scene, *_planes(org, d),
                              RenderConfig(intersector="brute", trace="xla"),
                              **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == (n,) and a.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_kernel_kill_code_resolves(test_scene_bvh, rng, monkeypatch,
                                   stubbed_kernel):
    """tri == -2 from the kernel (met a blocker of another material first)
    resolves to the killed sentinels on every output plane."""
    scene, _ = test_scene_bvh
    n = 64

    def killing(rays, *a, **k):
        t, tri, u, v = _stub_trace_call(rays, *a, **k)
        kill = jnp.arange(n) % 2 == 0
        return jnp.where(kill, -1.0, t), jnp.where(kill, -2, tri), u, v

    monkeypatch.setattr(trace_cuda, "trace_call", killing)
    org, d, tb, tg = _light_queries(scene, rng, n)
    out = fused_trace_planes(scene, *_planes(org, d), stubbed_kernel,
                             t_bound=tb, target_mtl=tg, return_tri=True)
    bt, seen = fused_trace_planes(scene, *_planes(org, d),
                                  stubbed_kernel,
                                  t_bound=tb, target_mtl=tg, query="occlusion")
    k = np.arange(n) % 2 == 0
    for i, sentinel in ((0, -1.0), (6, -3.0), (7, 0.0), (8, -1.0)):
        np.testing.assert_array_equal(np.asarray(out[i])[k], sentinel)
    assert (np.asarray(bt)[k] == -1.0).all() and (np.asarray(seen)[k] == 0).all()


def test_trace_vjp_with_stubbed_kernel(test_scene_bvh, rng, stubbed_kernel):
    """The custom-VJP rule (diff/fast.fused_trace_diff) wraps whichever
    trace is dispatched: with the kernel path, gradients with respect to
    vertices and rays equal the plain path's."""
    from tinyraytracing_tpu.diff.fast import fused_trace_diff

    scene, _ = test_scene_bvh
    n = 128
    org, d = _box_rays(rng, n)
    tb = jnp.full((n,), 3.0e38, jnp.float32)
    tg = jnp.full((n,), -2.0, jnp.float32)
    w = jnp.asarray(rng.normal(size=(6, n)), jnp.float32)

    def loss(v0, ox, dz, cfg):
        s = dataclasses.replace(scene, v0=v0)
        out = fused_trace_diff(s, ox, org[:, 1], org[:, 2], d[:, 0], d[:, 1],
                               dz, cfg, tb, tg)
        return sum(jnp.sum(w[i] * jnp.where(out[6] >= 0, out[i], 0.0))
                   for i in range(6))

    args = (scene.v0, org[:, 0], d[:, 2])
    g_kernel = jax.grad(loss, argnums=(0, 1, 2))(*args, stubbed_kernel)
    g_plain = jax.grad(loss, argnums=(0, 1, 2))(
        *args, RenderConfig(intersector="brute", trace="xla"))
    for a, b in zip(g_kernel, g_plain):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    assert float(jnp.abs(g_kernel[0]).sum()) > 0


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_path(gpu, test_scene_bvh, rng):
    """The CUDA kernel against the plain path on the card (the same check
    as chip_smoke.py phase 4, at test size)."""
    scene, _ = test_scene_bvh
    org, d = _box_rays(rng, 4096)
    a = fused_trace_planes(scene, *_planes(org, d), RenderConfig(trace="cuda"),
                           return_tri=True)
    b = fused_trace_planes(scene, *_planes(org, d), RenderConfig(trace="xla"),
                           return_tri=True)
    ha, hb = np.asarray(a[6]) >= 0, np.asarray(b[6]) >= 0
    assert (ha == hb).mean() >= 0.999
    both = ha & hb
    np.testing.assert_allclose(np.asarray(a[0])[both], np.asarray(b[0])[both],
                               rtol=1e-4)


def test_chain_lookup_matches_indexing(rng):
    tab = jnp.asarray(rng.normal(size=(7, 3)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 7, size=(50,)), jnp.int32)
    np.testing.assert_array_equal(chain_lookup(tab, idx), tab[idx])
    planes = chain_lookup_planes(tab, idx)
    for c in range(3):
        np.testing.assert_array_equal(planes[c], tab[idx, c])
    # float-carried indices (the fused kernel returns mtl as f32)
    idx_f = idx.astype(jnp.float32)
    np.testing.assert_array_equal(chain_lookup(tab, idx_f), tab[idx])
    # big tables fall back to a real gather
    big = jnp.asarray(rng.normal(size=(200, 2)), jnp.float32)
    bidx = jnp.asarray(rng.integers(0, 200, size=(31,)), jnp.int32)
    np.testing.assert_array_equal(chain_lookup(big, bidx), big[bidx])


def test_fused_renderer_matches_scan_statistically(test_scene_paths):
    """The fused renderer must agree with the differentiable scan renderer
    in expectation (same estimator, different scheduling + RNG streams)."""
    from tinyraytracing_tpu.models.scene import load_scene
    from tinyraytracing_tpu.integrator.fused import render_fused_jit
    from tinyraytracing_tpu.render import render

    p = test_scene_paths
    scene, cam = load_scene(p["xml"], p["obj"], p["mtl"], p["basedir"],
                            with_bvh=True)
    cam = dataclasses.replace(cam, width=24, height=24)
    cfg = RenderConfig(intersector="bvh", max_depth=8)
    a = np.asarray(render(scene, cam, jax.random.PRNGKey(0), cfg, spp=16))
    b = np.asarray(
        render_fused_jit(scene, cam, jax.random.PRNGKey(3), cfg, 16, lanes=512)
    )
    assert np.all(np.isfinite(b))
    # MC agreement: means within noise, high correlation
    assert abs(a.mean() - b.mean()) < 0.15 * max(a.mean(), 1e-6)
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert corr > 0.9


def test_fused_renderer_deterministic(test_scene_bvh):
    from tinyraytracing_tpu.integrator.fused import render_fused_jit

    scene, cam = test_scene_bvh
    cam = dataclasses.replace(cam, width=16, height=16)
    cfg = RenderConfig(intersector="bvh", max_depth=4)
    a = np.asarray(render_fused_jit(scene, cam, jax.random.PRNGKey(1), cfg, 4, lanes=256))
    b = np.asarray(render_fused_jit(scene, cam, jax.random.PRNGKey(1), cfg, 4, lanes=256))
    c = np.asarray(render_fused_jit(scene, cam, jax.random.PRNGKey(9), cfg, 4, lanes=256))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_fused_renderer_slot_range(test_scene_bvh):
    """slot_base / n_slots must render bitwise the same slot rows as the
    full image — the contract tile-sharding relies on, guaranteed by the
    path-indexed RNG (randomness is a function of (path_id, bounce) only,
    never of the lane/epoch/shard a pixel lands on)."""
    from tinyraytracing_tpu.integrator.fused import render_fused

    scene, cam = test_scene_bvh
    cam = dataclasses.replace(cam, width=16, height=16)
    cfg = RenderConfig(intersector="bvh", max_depth=4)
    key = jax.random.PRNGKey(2)
    full, _ = jax.jit(
        lambda k: render_fused(scene, cam, k, cfg, 4, lanes=128)
    )(key)
    half, _ = jax.jit(
        lambda k: render_fused(scene, cam, k, cfg, 4, lanes=128,
                               slot_base=128, n_slots=128)
    )(key)
    np.testing.assert_array_equal(np.asarray(half)[:128], np.asarray(full)[128:256])


# ---------------------------------------------------------------------------
# queue-fed fused renderer (integrator/fused_queue.py)
# ---------------------------------------------------------------------------

def test_fused_queue_matches_scan_statistically(test_scene_paths):
    from tinyraytracing_tpu.models.scene import load_scene
    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit
    from tinyraytracing_tpu.render import render

    p = test_scene_paths
    scene, cam = load_scene(p["xml"], p["obj"], p["mtl"], p["basedir"],
                            with_bvh=True)
    cam = dataclasses.replace(cam, width=24, height=24)
    cfg = RenderConfig(intersector="bvh", max_depth=8)
    a = np.asarray(render(scene, cam, jax.random.PRNGKey(0), cfg, spp=16))
    b = np.asarray(
        render_fused_queue_jit(scene, cam, jax.random.PRNGKey(3), cfg, 16, lanes=512)
    )
    assert np.all(np.isfinite(b))
    assert abs(a.mean() - b.mean()) < 0.15 * max(a.mean(), 1e-6)
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert corr > 0.9


def test_fused_queue_matches_fused_persistent(test_scene_bvh):
    """Same key => both fused schedulers draw identical per-path randomness
    (path-indexed RNG), so their images agree sample-for-sample — up to
    float contraction differences between the two compiled programs: XLA
    fuses each renderer differently, a borderline ray can flip a hit in
    one program only, and that one sample shifts its pixel by
    O(value/spp). Observed on the CPU plain path: ~2% of elements (17 of
    768 with the standard 20-round threefry stream)."""
    from tinyraytracing_tpu.integrator.fused import render_fused_jit
    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit

    scene, cam = test_scene_bvh
    cam = dataclasses.replace(cam, width=16, height=16)
    cfg = RenderConfig(intersector="bvh", max_depth=6)
    key = jax.random.PRNGKey(4)
    a = np.asarray(render_fused_jit(scene, cam, key, cfg, 8, lanes=256))
    b = np.asarray(render_fused_queue_jit(scene, cam, key, cfg, 8, lanes=256))
    close = np.isclose(a, b, rtol=2e-4, atol=2e-5)
    assert close.mean() > 0.97, f"{(~close).sum()} of {close.size} elements differ"
    # flipped elements shift by O(one path's radiance / spp) — bound the
    # damage globally instead of element-wise
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-6)


def test_fused_queue_deterministic(test_scene_bvh):
    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit

    scene, cam = test_scene_bvh
    cam = dataclasses.replace(cam, width=16, height=16)
    cfg = RenderConfig(intersector="bvh", max_depth=4)
    a = np.asarray(render_fused_queue_jit(scene, cam, jax.random.PRNGKey(1), cfg, 4, lanes=256))
    b = np.asarray(render_fused_queue_jit(scene, cam, jax.random.PRNGKey(1), cfg, 4, lanes=256))
    c = np.asarray(render_fused_queue_jit(scene, cam, jax.random.PRNGKey(7), cfg, 4, lanes=256))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_fused_queue_chunked_bitwise_and_resume(test_scene_bvh, tmp_path):
    """Host-chunked execution (what checkpoint/resume is built on) is the
    SAME loop paused at chunk boundaries: image bitwise-equal to the
    one-shot while_loop on the CPU, and resuming from a mid-render
    checkpoint is bitwise-equal too."""
    from tinyraytracing_tpu.integrator.fused_queue import (
        render_fused_queue_chunked, render_fused_queue_jit)

    scene, cam = test_scene_bvh
    cam = dataclasses.replace(cam, width=16, height=16)
    cfg = RenderConfig(intersector="bvh", max_depth=4)
    key = jax.random.PRNGKey(2)
    one = np.asarray(render_fused_queue_jit(scene, cam, key, cfg, 4, lanes=256))
    img, rays = render_fused_queue_chunked(
        scene, cam, key, cfg, 4, lanes=256, target_chunk_s=1e-9
    )  # tiny target -> many small chunks
    np.testing.assert_array_equal(np.asarray(img).reshape(16, 16, 3), one)
    assert float(rays) > 0

    # preempt after two chunks (snapshot kept), then resume to the end
    p = str(tmp_path / "queue.npz")
    part = []
    render_fused_queue_chunked(
        scene, cam, key, cfg, 4, lanes=256, target_chunk_s=1e-9,
        checkpoint_path=p, stop_after_chunks=2,
        progress=lambda **kw: part.append(kw["it"]))
    assert (tmp_path / "queue.npz").exists() and len(part) == 2
    resumed = []
    img2, _ = render_fused_queue_chunked(
        scene, cam, key, cfg, 4, lanes=256, target_chunk_s=1e-9,
        checkpoint_path=p, resume=True,
        progress=lambda **kw: resumed.append(kw["it"]))
    assert resumed[0] > part[-1], "resume restarted from scratch"
    assert not (tmp_path / "queue.npz").exists()   # cleared when done
    np.testing.assert_array_equal(np.asarray(img2).reshape(16, 16, 3), one)


def test_fused_queue_max_iters_cap_drops_unfinished(test_scene_bvh):
    """When the iteration cap binds, unfinished paths (and their queued
    NEE) are dropped — the image must stay finite and bounded by the full
    render (pinning the cap-bound behavior flagged in round 2)."""
    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue

    scene, cam = test_scene_bvh
    cam = dataclasses.replace(cam, width=8, height=8)
    cfg = RenderConfig(intersector="bvh", max_depth=6)
    key = jax.random.PRNGKey(3)

    def run(mi):
        # max_iters is a Python static (branch inside render_fused_queue)
        return jax.jit(
            lambda s, c, k: render_fused_queue(
                s, c, k, cfg, 4, lanes=128, max_iters=mi)
        )(scene, cam, key)

    full, rays_full = run(10_000)
    capped, rays_capped = run(2)
    full, capped = np.asarray(full), np.asarray(capped)
    assert np.isfinite(capped).all() and (capped >= 0).all()
    assert float(rays_capped) < float(rays_full)
    assert capped.sum() <= full.sum() + 1e-4
    # with the cap beyond the loop's natural end the cap must be inert
    again, _ = run(10_000)
    np.testing.assert_array_equal(full, np.asarray(again))


def test_shadow_early_kill_target_material(rng):
    """Shadow queries with a target material: a hit of another material
    within the bound kills the lane (mtl == -3); an unobstructed ray to the
    light reports the light's material; bound-0 lanes park (mtl == -1).
    The BVH walk and the brute-force intersector must agree lane for lane
    (every blocked ray's hits are all of another material here, so the
    kill cannot depend on visit order)."""
    from tinyraytracing_tpu.models.procedural import cornell_box
    from tinyraytracing_tpu.ops.bvh import attach_bvh

    scene, _ = cornell_box(width=8, height=8)
    scene = attach_bvh(scene, CFG)
    light_mtl = float(np.asarray(scene.light_mtl)[0])
    n = 128
    under_light = np.tile([278.0, 100.0, 280.0], (n, 1)).astype(np.float32)
    off_side = np.tile([400.0, 50.0, 400.0], (n, 1)).astype(np.float32)
    target = np.array([278.0, 548.8, 280.0], np.float32)
    orgs = np.concatenate([under_light, off_side])
    dirs = target[None, :] - orgs
    dist = np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = dirs / dist
    o = jnp.asarray(orgs)
    d = jnp.asarray(dirs)
    tb = jnp.asarray(dist[:, 0])
    tg = jnp.full((2 * n,), light_mtl, jnp.float32)

    mtls = []
    for cfg in (CFG, CFG.replace(intersector="brute")):
        outs = fused_trace_planes(scene, *_planes(o, d), cfg, t_bound=tb,
                                  target_mtl=tg)
        mtl = np.asarray(outs[6])
        mtls.append(mtl)
        # clear column: straight up to the light
        assert (mtl[:n] == light_mtl).all(), mtl[:8]
        # second column: each lane is the light, a kill (-3), or a miss
        # (-1) — never a foreign positive material id
        assert np.isin(mtl[n:], [light_mtl, -3.0, -1.0]).all(), set(mtl[n:])
        # parked lanes: bound 0 -> no walk at all
        outs0 = fused_trace_planes(scene, *_planes(o, d), cfg,
                                   t_bound=jnp.zeros(2 * n), target_mtl=tg)
        assert (np.asarray(outs0[6]) == -1.0).all()
    np.testing.assert_array_equal(mtls[0], mtls[1])


def test_fused_trace_hbm_large_tree(rng):
    """A tree of ~2,000 nodes (quad_grid(6000)): the plain BVH walk
    against the brute-force intersector, hits and attributes."""
    from tinyraytracing_tpu.models.procedural import quad_grid
    from tinyraytracing_tpu.ops.bvh import attach_bvh

    cfg = RenderConfig(intersector="bvh", leaf_size=8)
    scene, _ = quad_grid(6000, width=16, height=16)
    scene = attach_bvh(scene, cfg)
    assert scene.bvh.n_nodes > 1024
    org = jnp.asarray(rng.uniform(100, 450, (128, 3)), jnp.float32)
    d = rng.normal(size=(128, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _check_fused(scene, org, jnp.asarray(d, jnp.float32), cfg)


def test_nee_mxu_onehot_row_select_exact(rng):
    """The large-K NEE table path (integrator/fused._nee_geometry): the
    bf16 one-hot built from the monotone prefix-compare, dotted at
    HIGHEST precision, must select table rows EXACTLY like the clamped
    count-gather — including rnd below the first prefix and beyond the
    real rows (zero pad row, masked by validity downstream)."""
    K = 97
    areas = rng.uniform(0.1, 2.0, K).astype(np.float32)
    prefix = np.cumsum(areas).astype(np.float32)
    prefix_pad = np.concatenate([prefix, np.full(31, np.inf, np.float32)])
    tab = np.zeros((K + 31, 18), np.float32)
    tab[:K] = rng.normal(size=(K, 18))
    R = 2048
    rnd = rng.uniform(0, prefix[-1] * 1.05, R).astype(np.float32)
    rnd[0] = 0.0
    rnd[1] = prefix[0]
    rnd[2] = np.nextafter(prefix[0], 0, dtype=np.float32)

    sel = np.minimum((prefix_pad[None, :] <= rnd[:, None]).sum(1), K + 30)
    want = tab[sel]

    pj, rj, tj = jnp.asarray(prefix_pad), jnp.asarray(rnd), jnp.asarray(tab)
    cmp = (pj[None, :] <= rj[:, None]).astype(jnp.bfloat16)
    prev = jnp.concatenate(
        [jnp.ones((R, 1), jnp.bfloat16), cmp[:, :-1]], axis=1
    )
    onehot = (1.0 - cmp) * prev
    got = jax.lax.dot_general(
        onehot.astype(jnp.float32), tj, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_fused_queue_shadow_compact_bitwise(reference_scenes):
    """Shadow-lane compaction (config.shadow_compact) is a pure
    permutation: live lanes are packed to each light segment's front for
    the occlusion query and inverse-sorted after, and per-lane results do
    not depend on a lane's neighbours — the image must be BITWISE the
    uncompacted renderer's. veach-mis (3 lights) exercises the (L, R)
    segment reshapes nontrivially."""
    import dataclasses

    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit
    from tinyraytracing_tpu.models.scene import load_scene

    base = f"{reference_scenes}/veach-mis"
    scene, cam = load_scene(f"{base}/veach-mis.xml", f"{base}/veach-mis.obj",
                            f"{base}/veach-mis.mtl", base, with_bvh=True)
    cam = dataclasses.replace(cam, width=16, height=16)
    key = jax.random.PRNGKey(5)
    cfg = RenderConfig(intersector="bvh", max_depth=4, shadow_test="mtl")
    off = np.asarray(render_fused_queue_jit(
        scene, cam, key, cfg.replace(shadow_compact="off"), 2, lanes=256))
    on = np.asarray(render_fused_queue_jit(
        scene, cam, key, cfg.replace(shadow_compact="on"), 2, lanes=256))
    np.testing.assert_array_equal(on, off)
