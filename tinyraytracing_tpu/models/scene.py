"""Scene: device-side SoA representation of geometry, materials, lights,
textures, and (optionally) a flattened BVH.

This dissolves the reference's pointer-heavy Scene/Material/Triangle classes
(RayTracingOnCPU/scene.h, material.h, triangle.h) into flat arrays uploaded
once to HBM:

- geometry: per-triangle vertex/normal/texcoord SoA (reference keeps
  ``vector<Triangle>`` with per-triangle strings, scene.cpp:115-213)
- materials: a table indexed by int32 id replacing the name-keyed
  ``unordered_map<string, Material>`` (per-hit string hashing in the
  reference's inner loop, pathTracing.cpp:9-15!)
- lights: per-light padded triangle tables with **prefix-area CDFs**
  replicating the reference's running-prefix ``triangle.area`` trick
  (scene.cpp:199-205) and its NEE pick loop (pathTracing.cpp:38-43)
- textures: one padded atlas (io/textures.py)

The reference's load-order constraint (xml→obj→mtl, main.cpp:66-69) is
dissolved into explicit dataflow: parse everything, then assemble.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from tinyraytracing_tpu.io.mtl import MaterialSpec, parse_mtl
from tinyraytracing_tpu.io.objmesh import MeshArrays, parse_obj, triangle_areas
from tinyraytracing_tpu.io.textures import load_texture_atlas
from tinyraytracing_tpu.io.xmlscene import SceneConfig, parse_scene_xml
from tinyraytracing_tpu.models.camera import Camera

def _static():
    return dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BVHArrays:
    """Flattened stackless BVH in depth-first preorder (ops/bvh.py)."""

    nmin: jax.Array        # (N, 3) AABB min (includes reference's 1e-3 pad)
    nmax: jax.Array        # (N, 3) AABB max
    start: jax.Array       # (N,) first triangle of leaf range (0 if internal)
    count: jax.Array       # (N,) leaf triangle count (0 => internal node)
    skip: jax.Array        # (N,) next preorder node when skipping this subtree
    n_nodes: int = _static()
    leaf_size: int = _static()
    # --- static topology (ops/bvh.bvh_arrays) ---
    # vertex moves keep the tree SHAPE and only rewrite boxes (diff/
    # refit.py): tri_leaf maps each (permuted) triangle to its leaf node;
    # level + child indices drive the bottom-up box propagation per level.
    # n_levels (the tree depth) also bounds the CUDA trace's stack.
    tri_leaf: jax.Array | None = None   # (T,) leaf node id per triangle
    level: jax.Array | None = None      # (N,) depth of each node (root 0)
    child_l: jax.Array | None = None    # (N,) left child (i+1) or -1
    child_r: jax.Array | None = None    # (N,) right child (skip[i+1]) or -1
    n_levels: int = dataclasses.field(default=0, metadata=dict(static=True))
    # the pad the BUILDER applied to every box (bvh.cpp:31-40); the refit
    # pass (diff/refit.py) re-applies this exact value so propagated boxes
    # equal a from-scratch build even under a non-default config.aabb_pad
    aabb_pad: float = dataclasses.field(default=1e-3, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    # --- geometry (T triangles) ---
    v0: jax.Array          # (T, 3)
    v1: jax.Array
    v2: jax.Array
    n0: jax.Array          # (T, 3) shading normals
    n1: jax.Array
    n2: jax.Array
    t0: jax.Array          # (T, 2) texcoords
    t1: jax.Array
    t2: jax.Array
    gn: jax.Array          # (T, 3) geometric normal (reference triangle.normal)
    woop_a: jax.Array      # (T, 3, 3) Woop inverse transform rows (u, v, w)
    woop_b: jax.Array      # (T, 3) Woop offset: local = woop_a @ p + woop_b
    tri_mtl: jax.Array     # (T,) int32
    tri_emissive: jax.Array  # (T,) bool
    # --- materials (M) ---
    kd: jax.Array          # (M, 3)
    ks: jax.Array          # (M, 3)
    tr: jax.Array          # (M, 3)
    ns: jax.Array          # (M,)
    ni: jax.Array          # (M,)
    radiance: jax.Array    # (M, 3)
    mtl_emissive: jax.Array  # (M,) bool
    tex_id: jax.Array      # (M,) int32, -1 = no texture
    # --- lights (L, padded to K triangles each) ---
    light_mtl: jax.Array   # (L,) int32
    light_radiance: jax.Array  # (L, 3)
    lt_v0: jax.Array       # (L, K, 3) light triangle vertices
    lt_v1: jax.Array
    lt_v2: jax.Array
    lt_n0: jax.Array       # (L, K, 3) light triangle shading normals
    lt_n1: jax.Array
    lt_n2: jax.Array
    lt_prefix: jax.Array   # (L, K) prefix areas, +inf padding
    lt_tri: jax.Array      # (L, K) int32 triangle index of each light-table
    #   entry IN THE SCENE'S (possibly BVH-permuted) triangle order, 0 for
    #   padding — lets diff.inverse.apply_params keep the NEE light tables
    #   consistent when vertex offsets move emissive geometry
    light_area: jax.Array  # (L,) true total area per light
    nee_range: jax.Array   # () area of lights[0] — the reference's static-
    #                          distribution quirk (pathTracing.cpp:37-38)
    # --- textures ---
    tex: jax.Array         # (NT, Hmax, Wmax, 3) float32
    tex_hw: jax.Array      # (NT, 2) int32
    # --- acceleration structure (optional) ---
    bvh: BVHArrays | None
    # --- static metadata ---
    mtl_names: tuple = _static()
    light_names: tuple = _static()
    # per-light REAL triangle counts (the lt_* tables are padded to the
    # max K across lights): static, so NEE can slice each light's tables
    # to its true size — staircase pads its five 2-8-triangle lights to
    # K=480, which forced all six lights through the (R, K) one-hot
    # matmul CDF path every iteration (round 5)
    lt_counts: tuple = dataclasses.field(
        default=(), metadata=dict(static=True)
    )

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_mtl.shape[0]

    @property
    def num_materials(self) -> int:
        return self.kd.shape[0]


def woop_transform(tri_v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-triangle affine transform to unit-barycentric space (Woop et al.'s
    watertight formulation adapted to SoA): local = A @ p + b maps v0 to the
    origin, v1 to (1,0,0)-ish, v2 to (0,1,0)-ish, with the third coordinate
    the (unnormalized) plane offset. Intersection then becomes LINEAR in the
    ray (origin, direction) — two matmuls per ray batch (ops/intersect.py
    mxu backend) instead of per-triangle cross products.

    Rows (computed in float64 for robustness):
      A = [cross(e2, n); cross(n, e1); n] / (n . n),  b = -A @ v0
    with e1 = v1-v0, e2 = v2-v0, n = e1 x e2. Degenerate triangles get
    zero rows (every ray misses; the |dot(gn, d)| cull also rejects them).
    """
    v = np.asarray(tri_v, dtype=np.float64)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    det = np.einsum("ij,ij->i", n, n)
    safe = det > 1e-24
    inv_det = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
    rows = np.stack(
        [np.cross(e2, n), np.cross(n, e1), n], axis=1
    ) * inv_det[:, None, None]                       # (T, 3, 3)
    b = -np.einsum("tij,tj->ti", rows, v[:, 0])      # (T, 3)
    return rows, b


def assemble_scene(
    config: SceneConfig,
    mesh: MeshArrays,
    materials: dict[str, MaterialSpec],
    basedir: str = "",
    bvh_host: tuple | None = None,
) -> Scene:
    """Build a device Scene from parsed host data.

    ``bvh_host``: optional (nodes_dict, permutation) from ops.bvh.build_bvh;
    per-triangle arrays are permuted to leaf order HOST-SIDE before upload
    (no device->host readback). Light
    tables are always built from the ORIGINAL obj order, matching the
    reference where readobj fills materials[].triangles before buildBVH
    reorders the global vector (main.cpp:66-76).
    """
    # --- material table: encounter order = xml lights, obj usemtl, mtl file
    names: list[str] = []
    index: dict[str, int] = {}

    def intern(n: str) -> int:
        if n not in index:
            index[n] = len(names)
            names.append(n)
        return index[n]

    for l in config.lights:
        intern(l.mtl_name)
    for n in mesh.mtl_names:
        intern(n)
    for n in materials:
        intern(n)

    M = len(names)
    kd = np.zeros((M, 3), np.float32)
    ks = np.zeros((M, 3), np.float32)
    tr = np.zeros((M, 3), np.float32)
    ns = np.ones((M,), np.float32)
    ni = np.ones((M,), np.float32)
    radiance = np.zeros((M, 3), np.float32)
    emissive = np.zeros((M,), bool)
    tex_id = np.full((M,), -1, np.int32)

    tex_paths: list[str] = []
    for n, i in index.items():
        spec = materials.get(n)
        if spec is not None:
            kd[i], ks[i], tr[i] = spec.kd, spec.ks, spec.tr
            ns[i], ni[i] = spec.ns, spec.ni
            if spec.map_kd:
                path = os.path.join(basedir, spec.map_kd) if basedir else spec.map_kd
                if path not in tex_paths:
                    tex_paths.append(path)
                tex_id[i] = tex_paths.index(path)
    for l in config.lights:
        emissive[index[l.mtl_name]] = True
        radiance[index[l.mtl_name]] = l.radiance

    atlas, tex_hw = load_texture_atlas(tex_paths)

    # --- geometry, remapped to global material ids
    obj_to_global = np.asarray([intern(n) for n in mesh.mtl_names], np.int32)
    tri_mtl = obj_to_global[mesh.mtl]
    tri_emissive = emissive[tri_mtl]

    # --- light triangle tables with prefix-area CDFs (obj order, like the
    # reference's materials[m].triangles push_back at scene.cpp:199-205)
    L = max(len(config.lights), 1)
    areas = triangle_areas(mesh.v)
    counts = []
    per_light: list[np.ndarray] = []
    for l in config.lights:
        sel = np.nonzero(tri_mtl == index[l.mtl_name])[0]
        per_light.append(sel)
        counts.append(len(sel))
    K = max(max(counts, default=0), 1)

    lt_v = np.zeros((L, K, 3, 3), np.float32)
    lt_n = np.zeros((L, K, 3, 3), np.float32)
    lt_prefix = np.full((L, K), np.inf, np.float32)
    lt_tri = np.zeros((L, K), np.int32)
    light_area = np.zeros((L,), np.float32)
    light_mtl = np.zeros((L,), np.int32)
    light_radiance = np.zeros((L, 3), np.float32)
    # map original-order triangle ids into the scene's final (possibly
    # BVH-permuted) order for lt_tri
    T = mesh.v.shape[0]
    inv_perm = np.arange(T, dtype=np.int64)
    if bvh_host is not None:
        inv_perm[np.asarray(bvh_host[1])] = np.arange(T)
    for li, l in enumerate(config.lights):
        sel = per_light[li]
        light_mtl[li] = index[l.mtl_name]
        light_radiance[li] = l.radiance
        if len(sel):
            lt_v[li, : len(sel)] = mesh.v[sel]
            lt_n[li, : len(sel)] = mesh.vn[sel]
            lt_tri[li, : len(sel)] = inv_perm[sel]
            pref = np.cumsum(areas[sel])
            lt_prefix[li, : len(sel)] = pref
            light_area[li] = pref[-1]
    nee_range = light_area[0] if len(config.lights) else np.float32(0)

    # optional host-side BVH permutation of the per-triangle arrays
    tv, tvn, tvt, tgn = mesh.v, mesh.vn, mesh.vt, mesh.normal
    bvh_arrays = None
    if bvh_host is not None:
        nodes, perm = bvh_host
        tv, tvn, tvt, tgn = tv[perm], tvn[perm], tvt[perm], tgn[perm]
        tri_mtl = tri_mtl[perm]
        tri_emissive = tri_emissive[perm]
        from tinyraytracing_tpu.ops.bvh import bvh_arrays as _bvh_arrays

        bvh_arrays = _bvh_arrays(nodes, int(nodes["leaf_size"]),
                                 float(nodes.get("aabb_pad", 1e-3)))
    woop_a, woop_b = woop_transform(tv)

    f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
    return Scene(
        v0=f32(tv[:, 0]), v1=f32(tv[:, 1]), v2=f32(tv[:, 2]),
        n0=f32(tvn[:, 0]), n1=f32(tvn[:, 1]), n2=f32(tvn[:, 2]),
        t0=f32(tvt[:, 0]), t1=f32(tvt[:, 1]), t2=f32(tvt[:, 2]),
        gn=f32(tgn),
        woop_a=f32(woop_a), woop_b=f32(woop_b),
        tri_mtl=jnp.asarray(tri_mtl),
        tri_emissive=jnp.asarray(tri_emissive),
        kd=f32(kd), ks=f32(ks), tr=f32(tr), ns=f32(ns), ni=f32(ni),
        radiance=f32(radiance),
        mtl_emissive=jnp.asarray(emissive),
        tex_id=jnp.asarray(tex_id),
        light_mtl=jnp.asarray(light_mtl),
        light_radiance=f32(light_radiance),
        lt_v0=f32(lt_v[:, :, 0]), lt_v1=f32(lt_v[:, :, 1]), lt_v2=f32(lt_v[:, :, 2]),
        lt_n0=f32(lt_n[:, :, 0]), lt_n1=f32(lt_n[:, :, 1]), lt_n2=f32(lt_n[:, :, 2]),
        lt_prefix=f32(lt_prefix),
        lt_tri=jnp.asarray(lt_tri),
        light_area=f32(light_area),
        nee_range=f32(nee_range),
        tex=jnp.asarray(atlas),
        tex_hw=jnp.asarray(tex_hw),
        bvh=bvh_arrays,
        mtl_names=tuple(names),
        light_names=tuple(l.mtl_name for l in config.lights),
        lt_counts=tuple(int(c) for c in counts),
    )


def load_scene(
    xml_path: str,
    obj_path: str,
    mtl_path: str,
    basedir: str | None = None,
    with_bvh: bool = False,
    leaf_size: int = 8,
    aabb_pad: float = 1e-3,
) -> tuple[Scene, Camera]:
    """Load a scene the way the reference driver does (main.cpp:66-69),
    returning the device Scene and the Camera from the XML. With
    ``with_bvh`` the SAH BVH is built host-side and attached."""
    if basedir is None:
        basedir = os.path.dirname(os.path.abspath(xml_path))
    config = parse_scene_xml(xml_path)
    try:
        from tinyraytracing_tpu.native import parse_obj_native

        mesh = parse_obj_native(obj_path)
    except ImportError:
        mesh = parse_obj(obj_path)
    materials = parse_mtl(mtl_path)
    bvh_host = None
    if with_bvh:
        from tinyraytracing_tpu.ops.bvh import build_bvh_host

        bvh_host = build_bvh_host(mesh.v, leaf_size, aabb_pad)
    scene = assemble_scene(config, mesh, materials, basedir, bvh_host=bvh_host)
    camera = Camera.create(
        config.eye, config.lookat, config.up, config.fovy,
        config.width, config.height,
    )
    return scene, camera
