"""Gradients on the FAST path: custom-VJP trace + planar renderer.

- ``fused_trace_diff``: ``jax.custom_vjp`` around the trace
  (ops/trace.fused_trace_planes, whichever way it is dispatched). FORWARD =
  the trace, returning the best-hit triangle index as well (return_tri).
  BACKWARD = path replay: with the hit triangle FIXED (sampling and hit
  selection are discrete/detached — the interior-term estimator,
  diff/__init__), the outputs (t, interpolated shading normal, texcoord)
  are closed-form Möller–Trumbore functions of (o, d, v0, v1, v2, n0..,
  t0..); the VJP of that closed form — gathers + segment-scatter handled
  by jax.vjp — yields ray and vertex gradients. The replay uses the same
  formula as the forward intersector, so its derivative is the derivative
  of what the forward computed (up to float32 rounding).
- ``render_diff``: fixed-depth planar wavefront renderer built from the
  same estimator pieces as the flagship queue renderer (fused._nee_geometry,
  sample_bsdf_planar, planar threefry RNG) but reverse-differentiable:
  lax.scan over bounces under jax.checkpoint (rematerialized backward),
  shadow visibility detached (discrete), sampling detached
  (config.detach_sampling). The estimator being differentiated is the
  reference's whole shade() recursion (RayTracingOnCPU/pathTracing.cpp:
  3-102 — NEE + Russian roulette + quirk flags), in the same planar form
  as integrator/wavefront.trace.

Vertex moves keep the BVH consistent via diff/refit.py (called from
inverse.apply_params) — the refit arrays are stop_gradient'd; all
geometry gradients flow through the replay, not the acceleration
structure.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tinyraytracing_tpu.config import (
    CAMERA,
    INVALID,
    SPECULAR,
    TRANSMISSION,
    RenderConfig,
)
from tinyraytracing_tpu.integrator.fused import (
    _material_planes,
    _nee_geometry,
    _tex_kd,
    sample_bsdf_planar,
)
from tinyraytracing_tpu.models.camera import camera_basis
from tinyraytracing_tpu.ops import vec
from tinyraytracing_tpu.ops.trace import (
    _INF,
    fused_trace_planes,
    occlusion_trace_segmented,
)
from tinyraytracing_tpu.ops.rng import (
    bits_to_uniform,
    bounce_uniforms,
    master_key_data,
    path_keys,
)


# one-hot row gather limit: up to this triangle count the replay reads
# per-ray triangle rows as an EXACT (R, T) one-hot matmul (0/1 operand at
# HIGHEST precision selects rows exactly — same trick as the NEE CDF
# fetch, integrator/fused._nee_geometry). Its VJP is the transposed
# matmul, i.e. the (T, C) cotangent segment-sum is one matmul instead of
# 9 per-bounce scatter-adds. Whether this beats gathers on the GPU is not
# measured yet.
_ONEHOT_T = 256


def _tri_rows(tab, i):
    T = tab.shape[0]
    if T > _ONEHOT_T:
        return tab[i]
    onehot = (jnp.arange(T, dtype=i.dtype)[None, :] == i[:, None]).astype(
        jnp.float32
    )
    return jax.lax.dot_general(
        onehot, tab, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


def _replay_outputs(v0, v1, v2, n0, n1, n2, t0, t1, t2,
                    ox, oy, oz, dx, dy, dz, tri, hit):
    """Closed-form (t, pn, tc) of the FIXED hit triangles — the function
    whose VJP is the interior-term backward. Non-hit lanes contribute 0."""
    i = jnp.maximum(tri, 0)
    a0, b0, c0 = _tri_rows(v0, i), _tri_rows(v1, i), _tri_rows(v2, i)
    o = jnp.stack([ox, oy, oz], axis=-1)
    d = jnp.stack([dx, dy, dz], axis=-1)
    e1 = b0 - a0
    e2 = c0 - a0
    p = jnp.cross(d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    safe = jnp.abs(det) > 1e-24
    inv = jnp.where(safe, 1.0, 0.0) / jnp.where(safe, det, 1.0)
    s = o - a0
    u = jnp.sum(s * p, axis=-1) * inv
    q = jnp.cross(s, e1)
    v = jnp.sum(d * q, axis=-1) * inv
    t = jnp.sum(e2 * q, axis=-1) * inv
    w = 1.0 - u - v
    m = hit.astype(jnp.float32)
    pn = (_tri_rows(n0, i) * w[:, None] + _tri_rows(n1, i) * u[:, None]
          + _tri_rows(n2, i) * v[:, None])
    tc = (_tri_rows(t0, i) * w[:, None] + _tri_rows(t1, i) * u[:, None]
          + _tri_rows(t2, i) * v[:, None])
    return (t * m, pn[:, 0] * m, pn[:, 1] * m, pn[:, 2] * m,
            tc[:, 0] * m, tc[:, 1] * m)


@partial(jax.custom_vjp, nondiff_argnums=(7,))
def fused_trace_diff(scene, ox, oy, oz, dx, dy, dz, config,
                     t_bound, target_mtl):
    """Differentiable trace: same 9-tuple as
    fused_trace_planes(return_tri=True); gradients flow to the rays and to
    scene.{v0,v1,v2,n0,n1,n2,t0,t1,t2} by path replay (module docstring).
    ``mtl``/``em``/``tri`` are discrete (zero gradient)."""
    return fused_trace_planes(
        scene, ox, oy, oz, dx, dy, dz, config,
        t_bound=t_bound, target_mtl=target_mtl, return_tri=True,
    )


def _ftd_fwd(scene, ox, oy, oz, dx, dy, dz, config, t_bound, target_mtl):
    out = fused_trace_planes(
        scene, ox, oy, oz, dx, dy, dz, config,
        t_bound=t_bound, target_mtl=target_mtl, return_tri=True,
    )
    tri_f = out[8]
    res = (scene, ox, oy, oz, dx, dy, dz,
           tri_f.astype(jnp.int32), tri_f >= 0.0)
    return out, res


def _ftd_bwd(config, res, cts):
    scene, ox, oy, oz, dx, dy, dz, tri, hit = res
    ct_t, ct_pnx, ct_pny, ct_pnz, ct_tcu, ct_tcv = cts[:6]
    # cts[6:9] (mtl, em, tri) are discrete outputs — dropped

    def f(v0, v1, v2, n0, n1, n2, t0, t1, t2, ox, oy, oz, dx, dy, dz):
        return _replay_outputs(v0, v1, v2, n0, n1, n2, t0, t1, t2,
                               ox, oy, oz, dx, dy, dz, tri, hit)

    primals = (scene.v0, scene.v1, scene.v2, scene.n0, scene.n1, scene.n2,
               scene.t0, scene.t1, scene.t2, ox, oy, oz, dx, dy, dz)
    _, vjp = jax.vjp(f, *primals)
    g = vjp((ct_t, ct_pnx, ct_pny, ct_pnz, ct_tcu, ct_tcv))

    def zero_ct(x):
        if jnp.issubdtype(x.dtype, jnp.inexact):
            return jnp.zeros(x.shape, x.dtype)
        return np.zeros(x.shape, jax.dtypes.float0)

    scene_ct = jax.tree.map(zero_ct, scene)
    import dataclasses

    scene_ct = dataclasses.replace(
        scene_ct, v0=g[0], v1=g[1], v2=g[2], n0=g[3], n1=g[4], n2=g[5],
        t0=g[6], t1=g[7], t2=g[8],
    )
    return (scene_ct, g[9], g[10], g[11], g[12], g[13], g[14],
            jnp.zeros_like(ox), jnp.zeros_like(ox))


fused_trace_diff.defvjp(_ftd_fwd, _ftd_bwd)


def render_diff(scene, cam, key, config: RenderConfig, spp: int,
                return_rays: bool = False, pix_lo=0,
                n_pix_local: int | None = None):
    """Fixed-depth differentiable render on the FAST (custom-VJP trace) path.

    Returns the (H, W, 3) linear mean image (with ``return_rays`` also the
    traced-ray count, for fwd+bwd rays/s reporting). The CUDA trace needs
    scene.bvh (attach_bvh; under vertex offsets apply_params refits it).
    Estimator semantics = integrator/wavefront.trace; RNG is
    path-indexed planar threefry (path = pixel*spp + sample), so the image
    is deterministic and scheduling-independent.

    ``pix_lo`` (may be traced — a shard offset) and ``n_pix_local``
    (static) select a contiguous pixel slice for tile-sharded multi-chip
    differentiation (parallel/mesh.render_loss_fast_sharded): the return
    is then the flat (n_pix_local, 3) slice instead of (H, W, 3). The
    path-indexed RNG makes every pixel's value independent of the
    partitioning.
    """
    W, H = cam.width, cam.height
    n_pix = W * H
    sliced = n_pix_local is not None
    R = n_pix_local if sliced else n_pix
    shape = (R,)
    L = scene.light_mtl.shape[0]
    light_mtl_f = [scene.light_mtl[l].astype(jnp.float32) for l in range(L)]
    key_data = master_key_data(key)
    eye, horizontal, vertical, llc = camera_basis(cam)
    eye = tuple(eye[k] for k in range(3))
    horizontal = tuple(horizontal[k] for k in range(3))
    vertical = tuple(vertical[k] for k in range(3))
    llc = tuple(llc[k] for k in range(3))
    pix = jnp.minimum(pix_lo + jnp.arange(R, dtype=jnp.int32), n_pix - 1)
    far3 = vec.splat(jnp.asarray([1e30, 1e30, 1e30]), shape)
    up = vec.splat(jnp.asarray([0.0, 0.0, 1.0]), shape)
    detach = jax.lax.stop_gradient if config.detach_sampling else (lambda x: x)

    def camera_ray(path_id):
        i = (pix // W).astype(jnp.float32)
        j = (pix % W).astype(jnp.float32)
        pk0, pk1 = path_keys(key_data, path_id)
        h1 = bits_to_uniform(pk0)
        h2 = bits_to_uniform(pk1)
        x = j / (W - 1.0) + (h1 - 0.5) / W
        y = (H - i) / (H - 1.0) + (h2 - 0.5) / H
        d = (
            llc[0] + x * horizontal[0] + y * vertical[0] - eye[0],
            llc[1] + x * horizontal[1] + y * vertical[1] - eye[1],
            llc[2] + x * horizontal[2] + y * vertical[2] - eye[2],
        )
        d = vec.normalize(d)
        o = vec.splat(eye, d[0].shape)
        return o, d, (pk0, pk1)

    def one_pass(s):
        path_id = pix * spp + s
        o, d, pkd = camera_ray(path_id)
        one = jnp.ones(shape, jnp.float32)
        zero = jnp.zeros(shape, jnp.float32)
        init = (
            jnp.ones(shape, bool),                 # active
            o, d,
            jnp.full(shape, CAMERA, jnp.int32),    # ray_type
            (one, one, one),                       # throughput
            (zero, zero, zero),                    # radiance
            zero,                                  # rays traced
        )

        @jax.checkpoint
        def bounce(carry, b):
            active, o, d, ray_type, thr, rad, rays = carry
            o_m = vec.where(active, o, far3)
            t, pnx, pny, pnz, tcu, tcv, mtl, em, _tri = fused_trace_diff(
                scene, o_m[0], o_m[1], o_m[2], d[0], d[1], d[2], config,
                jnp.where(active, jnp.float32(_INF), 0.0),
                jnp.full(shape, -2.0),
            )
            rays = rays + active.astype(jnp.float32)
            hit = mtl >= 0.0
            point = vec.add(o_m, vec.scale(d, t))
            pn = vec.normalize((pnx, pny, pnz))
            hit_emissive = hit & (em > 0.5)
            include = (ray_type == CAMERA) | (ray_type == TRANSMISSION)
            emit = active & hit_emissive & include
            mat = _material_planes(scene, mtl)
            mrad = mat["rad"]
            rad = (
                rad[0] + jnp.where(emit, thr[0] * mrad[0], 0.0),
                rad[1] + jnp.where(emit, thr[1] * mrad[1], 0.0),
                rad[2] + jnp.where(emit, thr[2] * mrad[2], 0.0),
            )
            shade_mask = active & hit & ~hit_emissive
            kd_val = _tex_kd(scene, mat, tcu, tcv, mat["kd"])
            ks, ns = mat["ks"], mat["ns"]
            wi = vec.neg(d)
            draws = bounce_uniforms(pkd[0], pkd[1], b, 4 * L + 5)

            pend, sh_o, sh_d = [], [], []
            for l in range(L):
                wo, contrib, distl, okl = _nee_geometry(
                    scene, config, l, point, pn, wi, kd_val, ks, ns,
                    draws[4 * l + 0], draws[4 * l + 1],
                    draws[4 * l + 2], draws[4 * l + 3],
                    shade_mask,
                )
                pend.append((okl, contrib, distl))
                sh_o.append(vec.where(okl, point, far3))
                sh_d.append(vec.where(okl, wo, up))
            cat = lambda xs: jnp.concatenate(xs)
            sg = jax.lax.stop_gradient
            # visibility is discrete: the shadow trace runs OUTSIDE the
            # gradient path (plain trace on detached inputs)
            occl_q = config.shadow_test == "mtl"
            sh_args = (
                sg(cat([s[0] for s in sh_o])), sg(cat([s[1] for s in sh_o])),
                sg(cat([s[2] for s in sh_o])),
                sg(cat([s[0] for s in sh_d])), sg(cat([s[1] for s in sh_d])),
                sg(cat([s[2] for s in sh_d])),
            )
            sh_tb = sg(cat([jnp.where(okl, distl, 0.0)
                            for (okl, _, distl) in pend]))
            sh_tg = cat([jnp.where(okl, light_mtl_f[l], -2.0)
                         for l, (okl, _, _) in enumerate(pend)])
            if occl_q:
                # the occlusion query with per-light live-lane compaction
                # on big trees (ops/trace.occlusion_trace_segmented);
                # everything here is detached, so the compaction sorts
                # never enter the differentiated graph
                svis = occlusion_trace_segmented(
                    scene, *sh_args, sh_tb, sg(sh_tg), config, L,
                )
            else:
                st, _, _, _, _, _, smtl, _ = fused_trace_planes(
                    scene, *sh_args, config, t_bound=sh_tb,
                    target_mtl=sh_tg, attrs=False,
                )
            for l, (okl, contrib, distl) in enumerate(pend):
                sl = slice(l * R, (l + 1) * R)
                if occl_q:
                    vis = svis[sl] > 0.5
                else:
                    occ = (smtl[sl] == -3.0) | (
                        (smtl[sl] >= 0.0) & (st[sl] < sg(distl) - 1e-3)
                    )
                    vis = ~occ
                add = okl & vis
                rad = (
                    rad[0] + jnp.where(add, thr[0] * contrib[0], 0.0),
                    rad[1] + jnp.where(add, thr[1] * contrib[1], 0.0),
                    rad[2] + jnp.where(add, thr[2] * contrib[2], 0.0),
                )
                rays = rays + okl.astype(jnp.float32)

            u = [draws[4 * L + i] for i in range(5)]
            survive = shade_mask & (u[0] < config.p_rr) & (b + 1 < config.max_depth)
            new_dir, new_type = sample_bsdf_planar(
                detach(d), detach(pn), mat["kd"], ks, ns, mat["ni"],
                u[1], u[2], u[3], u[4],
            )
            new_dir = (detach(new_dir[0]), detach(new_dir[1]),
                       detach(new_dir[2]))
            alive_next = survive & (new_type != INVALID)
            if config.specular_weight == "ref":
                ds_weight = kd_val
            else:
                ds_weight = vec.where(new_type == SPECULAR, ks, kd_val)
            weight = vec.where(new_type == TRANSMISSION, mat["tr"], ds_weight)
            inv_prr = jnp.float32(1.0 / config.p_rr)
            thr = vec.where(
                alive_next,
                (thr[0] * weight[0] * inv_prr,
                 thr[1] * weight[1] * inv_prr,
                 thr[2] * weight[2] * inv_prr),
                thr,
            )
            o = vec.where(alive_next, point, o)
            d = vec.where(alive_next, new_dir, up)
            ray_type = jnp.where(alive_next, new_type, ray_type)
            return (alive_next, o, d, ray_type, thr, rad, rays), None

        carry, _ = jax.lax.scan(bounce, init, jnp.arange(config.max_depth))
        _, _, _, _, _, rad, rays = carry
        return jnp.stack(rad, axis=-1), jnp.sum(rays)

    def spp_body(acc, s):
        img, rays = one_pass(s)
        return (acc[0] + img, acc[1] + rays), None

    acc0 = (jnp.zeros((R, 3), jnp.float32), jnp.float32(0.0))
    (img, rays), _ = jax.lax.scan(spp_body, acc0, jnp.arange(spp))
    img = img / spp
    if not sliced:
        img = img.reshape(H, W, 3)
    if return_rays:
        return img, rays
    return img


def render_loss_fast(params, scene, cam, key, target, config: RenderConfig,
                     spp: int, edge_samples: int = 0,
                     shadow_edge_samples: int = 0, edge_aux=None,
                     edge_delta: float = 0.1, shadow_light: int = 0):
    """MSE pixel loss through the FAST differentiable path: apply_params
    (BVH refit under vertex offsets) + render_diff (custom-VJP fused
    trace). The fast-path counterpart of diff.inverse.render_loss.

    EDGE-SAMPLED BOUNDARY TERMS (opt-in, diff/edge.py): the
    interior-term replay above differentiates with the hit set fixed, so
    losses dominated by moving silhouettes or shadow boundaries get ~zero
    gradients. With ``edge_samples > 0`` the loss's GRADIENT additionally
    carries the primary-visibility boundary term (view-dependent
    silhouettes, closed meshes included); with ``shadow_edge_samples > 0``
    the secondary (shadow-silhouette) term for camera-visible shading
    points under planar light ``shadow_light``. The surrogate terms are
    value-neutral (x - stop_gradient(x)), so the returned LOSS value is
    unchanged — only jax.grad sees the boundary contributions.

    ``edge_aux``: precomputed ``diff.edge.build_edge_aux(scene)`` — build
    it once OUTSIDE jit (edge topology needs concrete vertex data).
    Limits (FD-validated at the scales in tests/test_diff_edge.py):
    single-scattering boundary terms only; shadow term uses the constant-
    Kd diffuse integrand on planar lights.
    """
    from tinyraytracing_tpu.diff.inverse import apply_params

    s2, c2 = apply_params(scene, cam, params)
    img = render_diff(s2, c2, key, config, spp)
    loss = jnp.mean((img - target) ** 2)
    if edge_samples or shadow_edge_samples:
        from tinyraytracing_tpu.diff import edge as _edge

        if edge_aux is None:
            edge_aux = _edge.build_edge_aux(scene)   # needs concrete scene
        sg = jax.lax.stop_gradient
        if edge_samples:
            sur = _edge.primary_edge_surrogate(
                s2, c2, config, target, jax.random.fold_in(key, 101),
                edge_aux, edge_samples, edge_delta, spp=1,
            )
            loss = loss + (sur - sg(sur))
        if shadow_edge_samples:
            sur2 = _edge.shadow_edge_surrogate(
                s2, c2, config, target, sg(img),
                jax.random.fold_in(key, 102), edge_aux,
                shadow_edge_samples, light=shadow_light,
            )
            loss = loss + (sur2 - sg(sur2))
    return loss
