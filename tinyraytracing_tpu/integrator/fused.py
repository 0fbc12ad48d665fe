"""Fused pixel-persistent wavefront — the forward renderer for tiny scenes.

Fourth-generation renderer. Generations and what each one fixed:

1. wavefront.py fixed-depth scan      — correctness baseline, differentiable
2. regen.py regeneration/persistent   — lane occupancy (RR-killed lanes
   restart immediately), dense epoch writes instead of scatter
3. planar (retired)                   — component-planar (R,) state for full
   lane utilization + deferred NEE so each iteration issues ONE trace
4. THIS — planar state with every per-triangle lookup folded into the
   trace:

   - the trace (ops/trace.py) returns the barycentric-interpolated shading
     normal, texcoord, material id and emissive flag alongside the hit
     distance;
   - material and light-triangle tables are resolved with fused select
     chains (ops/lookup.py) — pure elementwise code;
   - the only remaining gather is the texture fetch, and only for scenes
     that have textures.

Scheduling (inherited from the retired planar renderer):

- PIXEL-PERSISTENT epochs: lane l serves pixel (base + epoch*R + l) for all
  its spp samples, accumulating into a lane register; the epoch block is
  written densely (no scatter-add).
- DEFERRED NEE: iteration i's single trace covers
  [bounce-i rays | bounce-(i-1) shadow rays]; the pending NEE term (already
  multiplied by throughput) resolves one iteration late, which is sound
  because the pixel estimator is purely additive per lane. If the
  ``max_iters`` cap binds (3x expected-length slack + drain margin, so it
  practically never does), the final iteration's queued NEE contributions
  are dropped along with its unfinished paths.

Estimator semantics are IDENTICAL to wavefront.trace / regen renderers
(reference RayTracingOnCPU/pathTracing.cpp:3-102 NEE + RR + quirk flags,
see integrator/nee.py + integrator/bsdf.py for file:line parity notes).
RNG is PATH-INDEXED counter-based threefry: every draw is a function of
(path_id, bounce) alone — each lane carries its path key and folds in the
bounce index — so the image is BITWISE identical for a given key no matter
how pixels are partitioned into lanes, epochs, or device shards
(tests/test_trace.py::test_fused_renderer_slot_range). It differs
from the scan renderer's streams, so those images agree in distribution,
not bitwise (tests checked for MC agreement).

Forward-only (lax.while_loop); gradients use the fixed-depth scan path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tinyraytracing_tpu.config import (
    CAMERA,
    DIFFUSE,
    INVALID,
    SPECULAR,
    TRANSMISSION,
    RenderConfig,
)
from tinyraytracing_tpu.models.camera import Camera, camera_basis
from tinyraytracing_tpu.ops import vec
from tinyraytracing_tpu.ops.lookup import CHAIN_LIMIT, chain_lookup, chain_lookup_planes
from tinyraytracing_tpu.ops.rng import (
    bits_to_uniform,
    bounce_uniforms,
    master_key_data,
    path_keys,
)
from tinyraytracing_tpu.ops.sampling import PI

_INF = jnp.float32(3.0e38)


# ---------------------------------------------------------------------------
# planar BSDF sampling (reference nextRay(), pathTracing.cpp:147-209)
# ---------------------------------------------------------------------------

def sample_lobe_planar(axis, u_phi, u_theta, is_diffuse, ns):
    """Planar ops/sampling.sample_lobe (reference Sample(),
    pathTracing.cpp:111-145)."""
    ax, ay, az = axis
    phi = (2.0 * PI) * u_phi
    theta_d = jnp.arcsin(jnp.sqrt(jnp.clip(u_theta, 0.0, 1.0)))
    theta_s = jnp.arccos(
        jnp.clip(jnp.power(jnp.maximum(u_theta, 1e-30), 1.0 / (ns + 1.0)), -1.0, 1.0)
    )
    theta = jnp.where(is_diffuse, theta_d, theta_s)
    st = jnp.sin(theta)
    sx = st * jnp.cos(phi)
    sy = jnp.cos(theta)
    sz = st * jnp.sin(phi)
    # reference ONB (pathTracing.cpp:131-144)
    zeros = jnp.zeros_like(ax)
    pickx = jnp.abs(ax) > jnp.abs(ay)
    front = vec.normalize(vec.where(
        pickx, (az, zeros, -ax), (zeros, -az, ay)
    ))
    right = vec.cross(axis, front)
    return vec.normalize((
        right[0] * sx + ax * sy + front[0] * sz,
        right[1] * sx + ay * sy + front[1] * sz,
        right[2] * sx + az * sy + front[2] * sz,
    ))


def sample_bsdf_planar(d, pn, kd, ks, ns, ni, u_fresnel, u_lobe, u_phi, u_theta):
    """Planar integrator/bsdf.sample_bsdf (reference nextRay(),
    pathTracing.cpp:147-209). Same decision tree, component planes."""
    cos_in = vec.dot(d, pn)
    exiting = cos_in > 0.0
    normal = vec.where(exiting, vec.neg(pn), pn)
    n1 = jnp.where(exiting, ni, 1.0)
    n2 = jnp.where(exiting, 1.0, ni)
    rf0 = jnp.square((n1 - n2) / (n1 + n2))
    fresnel = rf0 + (1.0 - rf0) * jnp.power(1.0 - jnp.abs(cos_in), 5.0)
    take_refract = (ni > 1.0) & (fresnel < u_fresnel)

    refr_dir, tir = vec.refract(d, normal, n1 / n2)
    mirror_normal = vec.reflect(d, normal)

    kd_len = vec.length(kd)
    ks_len = vec.length(ks)
    denom = kd_len + ks_len
    safe = denom > 0.0
    inv_denom = jnp.reciprocal(jnp.where(safe, denom, 1.0))
    kd_frac = jnp.where(safe, kd_len * inv_denom, 0.0)
    ks_frac = jnp.where(safe, ks_len * inv_denom, 0.0)

    is_diffuse = safe & (u_lobe < kd_frac)
    is_specular = safe & ~is_diffuse & (ns > 1.0) & (u_lobe < kd_frac + ks_frac)
    lobe_axis = vec.where(is_diffuse, pn, vec.reflect(d, pn))
    lobe_dir = sample_lobe_planar(lobe_axis, u_phi, u_theta, is_diffuse, ns)
    lobe_type = jnp.where(
        is_diffuse, DIFFUSE, jnp.where(is_specular, SPECULAR, INVALID)
    ).astype(jnp.int32)

    new_dir = vec.where(
        take_refract, vec.where(tir, mirror_normal, refr_dir), lobe_dir
    )
    ray_type = jnp.where(
        take_refract,
        jnp.where(tir, SPECULAR, TRANSMISSION).astype(jnp.int32),
        lobe_type,
    )
    return new_dir, ray_type


# ---------------------------------------------------------------------------
# gather-free scene lookups
# ---------------------------------------------------------------------------

def _material_planes(scene, m):
    """All material attributes at material-id plane ``m`` via select chains
    (zero gathers; see ops/lookup.py). Returns a dict of planes."""
    return dict(
        kd=chain_lookup_planes(scene.kd, m),
        ks=chain_lookup_planes(scene.ks, m),
        tr=chain_lookup_planes(scene.tr, m),
        rad=chain_lookup_planes(scene.radiance, m),
        ns=chain_lookup(scene.ns, m),
        ni=chain_lookup(scene.ni, m),
        tex_id=chain_lookup(scene.tex_id, m),
    )


def _tex_kd(scene, mat, tcu, tcv, kd_plain):
    """Kd from texture (interpolated UV, wrap, nearest — reference
    pathTracing.cpp:15-30) when the material has one, else material Kd.
    Statically skipped for scenes without textures (atlas is 1x1)."""
    if scene.tex.shape[1] == 1 and scene.tex.shape[2] == 1:
        return kd_plain
    tid = mat["tex_id"]
    has_tex = tid >= 0
    tid_safe = jnp.maximum(tid, 0)
    icol = tcu - jnp.floor(tcu)
    irow = tcv - jnp.floor(tcv)
    th = chain_lookup(scene.tex_hw[:, 0], tid_safe)
    tw = chain_lookup(scene.tex_hw[:, 1], tid_safe)
    r_ix = jnp.clip((irow * th).astype(jnp.int32), 0, th - 1)
    c_ix = jnp.clip((icol * tw).astype(jnp.int32), 0, tw - 1)
    # the one true gather left in the renderer (image-sized table)
    texel = scene.tex[tid_safe, r_ix, c_ix]
    texel = (texel[..., 0], texel[..., 1], texel[..., 2])
    return vec.where(has_tex, texel, kd_plain)


def _nee_geometry(scene, config, l, point, pn, wi, kd_val, ks, ns,
                  u_pick, u1, u2, u3, shade_mask):
    """Everything of light l's NEE term EXCEPT visibility (reference
    pathTracing.cpp:34-74 split at the shadow trace): returns the shadow
    direction, the pre-visibility contribution planes, the light distance,
    and the validity mask. All planar; light-table lookups are select
    chains over the K (few) light triangles."""
    # slice the padded tables to this light's REAL triangle count (static,
    # Scene.lt_counts): lights are padded to the max K across lights, and
    # without the slice a 2-triangle light in staircase pays the same
    # (R, 480) one-hot matmul as the 480-triangle one, every iteration
    K_pad = scene.lt_prefix.shape[1]
    K = K_pad
    if l < len(scene.lt_counts):
        K = max(min(int(scene.lt_counts[l]), K_pad), 1)
    prefix = scene.lt_prefix[l][:K]                   # (K,) +inf padded
    area = scene.light_area[l]
    if config.light_sampler == "ref":
        rnd = u_pick * scene.nee_range
    else:
        rnd = u_pick * area
    valid = rnd < area
    # first triangle with prefix > rnd == count of prefix <= rnd
    if K <= CHAIN_LIMIT:
        sel = jnp.zeros(rnd.shape, jnp.int32)
        for k in range(K):
            sel = sel + (prefix[k] <= rnd).astype(jnp.int32)
        sel = jnp.minimum(sel, K - 1)
        gat = lambda tab: chain_lookup_planes(tab[l][:K], sel)
        lv0, lv1, lv2 = gat(scene.lt_v0), gat(scene.lt_v1), gat(scene.lt_v2)
        ln0, ln1, ln2 = gat(scene.lt_n0), gat(scene.lt_n1), gat(scene.lt_n2)
    else:
        # Big light-triangle table (veach: K=760): the CDF pick and the
        # row fetch are ONE one-hot matmul instead of 18 per-lane gathers
        # (6 tables x 3 components) — the compare plane doubles as the
        # (exact bf16 0/1) one-hot operand, and dotting it against the
        # (K, 18) table at HIGHEST precision selects the row exactly
        # (products are val*1 / val*0). Whether this beats the gathers on
        # the GPU is not measured yet.
        tab = jnp.concatenate(
            [scene.lt_v0[l][:K], scene.lt_v1[l][:K], scene.lt_v2[l][:K],
             scene.lt_n0[l][:K], scene.lt_n1[l][:K], scene.lt_n2[l][:K]],
            axis=-1,
        )                                             # (K, 18)
        # cmp[r, k] = prefix[k] <= rnd[r] — a monotone 1...10...0 mask
        # (prefix ascends, +inf padded). The CDF pick is row index
        # sel = #true = the FIRST FALSE position, so the one-hot is
        # (~cmp) & cmp-shifted-right-with-leading-1 — exact 0/1 in bf16.
        # rnd beyond the real rows lands on a zero pad row, masked by
        # ``valid`` below (as the old clamped-gather path did).
        cmp = (prefix[None, :] <= rnd[:, None]).astype(jnp.bfloat16)
        prev = jnp.concatenate(
            [jnp.ones((cmp.shape[0], 1), jnp.bfloat16), cmp[:, :-1]], axis=1
        )
        onehot = (1.0 - cmp) * prev
        rows = jax.lax.dot_general(
            onehot.astype(jnp.float32), tab,
            (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )                                             # (R, 18)
        p = lambda c: rows[:, c]
        lv0, lv1, lv2 = (p(0), p(1), p(2)), (p(3), p(4), p(5)), (p(6), p(7), p(8))
        ln0, ln1, ln2 = (p(9), p(10), p(11)), (p(12), p(13), p(14)), (p(15), p(16), p(17))

    if config.light_sampler == "ref":
        s = u1 + u2 + u3
        s = jnp.where(s == 0.0, 1.0, s)
        p1, p2, p3 = u1 / s, u2 / s, u3 / s
    else:
        su = jnp.sqrt(jnp.clip(u1, 0.0, 1.0))
        p1, p2, p3 = 1.0 - su, su * (1.0 - u2), su * u2
    bc = lambda a, b, c: (
        a[0] * p1 + b[0] * p2 + c[0] * p3,
        a[1] * p1 + b[1] * p2 + c[1] * p3,
        a[2] * p1 + b[2] * p2 + c[2] * p3,
    )
    light_p = bc(lv0, lv1, lv2)
    light_n = vec.normalize(bc(ln0, ln1, ln2))

    to_light = vec.sub(light_p, point)
    r2 = jnp.maximum(vec.length2(to_light), 1e-20)
    dist = jnp.sqrt(r2)
    wo = vec.scale(to_light, jnp.reciprocal(jnp.maximum(dist, 1e-20)))

    cos_o = vec.dot(wo, pn)
    ok = shade_mask & valid & (cos_o > 0.0)

    cos_p = jnp.abs(vec.dot(wo, light_n))
    geom = cos_p * jnp.abs(cos_o) / r2 * area        # pdf = 1/area
    lr = scene.light_radiance[l]

    h = vec.normalize(vec.add(wi, wo))
    cos_alpha = jnp.maximum(vec.dot(pn, h), 0.0)
    phong_s = (ns + 2.0) * jnp.power(cos_alpha, ns) / (2.0 * PI)
    contrib = (
        lr[0] * geom * (kd_val[0] / PI + ks[0] * phong_s),
        lr[1] * geom * (kd_val[1] / PI + ks[1] * phong_s),
        lr[2] * geom * (kd_val[2] / PI + ks[2] * phong_s),
    )
    zero = jnp.zeros_like(geom)
    contrib = vec.where(ok, contrib, (zero, zero, zero))
    return wo, contrib, dist, ok


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

def pixel_tile_order(W: int, H: int, tile: int = 32):
    """Static pixel visitation order: 32x32 image tiles in row-major tile
    order, row-major within each tile, so neighbouring lanes (which run
    side by side on the device) trace neighbouring pixels and walk similar
    parts of the BVH. Returns (order, inv): order[slot] = pixel,
    inv[pixel] = slot.
    """
    ys, xs = np.mgrid[0:H, 0:W]
    key = (
        ((ys // tile) * ((W + tile - 1) // tile) + (xs // tile)).ravel()
        * (tile * tile)
        + (ys % tile).ravel() * tile
        + (xs % tile).ravel()
    )
    order = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size, dtype=np.int32)
    return order, inv


# parked rays: origin far outside any scene AABB so the root slab test
# rejects them and dead lanes cost one node visit
_FAR = 1.0e30


def render_fused(
    scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    lanes: int = 262144,
    max_iters: int | None = None,
    slot_base=0,
    n_slots: int | None = None,
):
    """Render with the fused pixel-persistent wavefront.

    Lanes serve pixels in 32x32-TILE order (``pixel_tile_order``): lane l of
    epoch e serves pixel order[slot_base + e*R + l]. Returns the flat
    (n_slots_padded, 3) linear image in SLOT order plus the traced-ray count
    (float32); use ``pixel_tile_order(W, H)[1]`` (or the whole-image helpers
    below) to unswizzle to pixel order once at the end.

    ``slot_base`` (may be traced — e.g. a shard offset under shard_map) and
    ``n_slots`` (static) select a slot range, enabling tile-sharded
    multi-chip rendering where every device runs its own epochs over its
    own slice of the image's tiles. RNG is path-indexed, so the rendered
    values are bitwise independent of the slot partitioning.

    The CUDA trace needs ``scene.bvh`` (load_scene(with_bvh=True) or
    ops.bvh.attach_bvh). The ray counter accumulates in
    float32: per-lane per-epoch counts stay below 2^24 (exact), the global
    total is a throughput statistic with ~1e-7 relative error.
    """
    from tinyraytracing_tpu.ops.trace import fused_trace_planes

    W, H = cam.width, cam.height
    n_pix_total = W * H
    if n_slots is None:
        n_slots = n_pix_total
    R = min(lanes, n_slots)
    R = -(-R // 128) * 128                           # full lane tiles
    n_epochs = -(-n_slots // R)
    if max_iters is None:
        max_iters = int(spp * (1.0 / (1.0 - config.p_rr)) * 3) + config.max_depth + 9

    order_np = pixel_tile_order(W, H)[0]
    # pad by R so every epoch's dynamic_slice window stays in bounds
    order = jnp.asarray(np.concatenate([order_np, np.zeros(R, np.int32)]))

    eye, horizontal, vertical, llc = camera_basis(cam)
    inv_spp = jnp.float32(1.0 / spp)
    L = scene.light_mtl.shape[0]
    light_mtl_f = [scene.light_mtl[l].astype(jnp.float32) for l in range(L)]
    shape = (R,)

    key_data = master_key_data(key)

    def camera_ray(path_id):
        """(org, dir, path_key_planes) for path ids (R,): jitter from the
        path key's raw bits, the key itself carried for bounce draws."""
        pix = path_id // spp
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

    # camera_basis returns (3,) arrays; keep scalar components
    eye = tuple(eye[k] for k in range(3))
    horizontal = tuple(horizontal[k] for k in range(3))
    vertical = tuple(vertical[k] for k in range(3))
    llc = tuple(llc[k] for k in range(3))

    def epoch(e, carry):
        img, rays_traced = carry
        lane = jnp.arange(R, dtype=jnp.int32)
        slot = slot_base + e * R + lane
        in_range = (lane + e * R < n_slots) & (slot < n_pix_total)
        pixel = jax.lax.dynamic_slice(order, (slot_base + e * R,), (R,))

        def cond(s):
            it = s[0]
            active, samples_done = s[1], s[2]
            pend_ok = s[12]
            more = jnp.any(active) | jnp.any(in_range & (samples_done < spp))
            for p in pend_ok:
                more = more | jnp.any(p)
            return (it < max_iters) & more

        def body(s):
            (it, active, samples_done, bounce, o, d, ray_type, thr, rad,
             accum, sh_o, sh_d, pend_ok, pend_c, pend_dist, pkd, ray_count) = s

            # --- regenerate: start the pixel's next sample on dead lanes
            can = ~active & in_range & (samples_done < spp)
            path_id = jnp.where(can, pixel * spp + samples_done, 0)
            norg, nd, npk = camera_ray(path_id)
            pkd = (jnp.where(can, npk[0], pkd[0]),
                   jnp.where(can, npk[1], pkd[1]))
            o = vec.where(can, norg, o)
            d = vec.where(can, nd, d)
            ray_type = jnp.where(can, CAMERA, ray_type)
            one = jnp.ones(shape, jnp.float32)
            zero = jnp.zeros(shape, jnp.float32)
            thr = vec.where(can, (one, one, one), thr)
            rad = vec.where(can, (zero, zero, zero), rad)
            bounce = jnp.where(can, 0, bounce)
            samples_done = samples_done + can.astype(jnp.int32)
            active = active | can

            # park dead lanes far outside the scene: a parked ray fails the
            # root AABB test and costs one node visit
            far = jnp.full(shape, _FAR, jnp.float32)
            far3 = (far, far, far)
            o = vec.where(active, o, far3)

            # --- ONE fused trace: [bounce rays | L shadow-ray groups];
            # shadow legs bound at their light distance (prunes everything
            # beyond the light), parked/dead lanes bound at 0
            cat = lambda main, sh: jnp.concatenate([main] + sh)
            ox = cat(o[0], [sh_o[l][0] for l in range(L)])
            oy = cat(o[1], [sh_o[l][1] for l in range(L)])
            oz = cat(o[2], [sh_o[l][2] for l in range(L)])
            dx = cat(d[0], [sh_d[l][0] for l in range(L)])
            dy = cat(d[1], [sh_d[l][1] for l in range(L)])
            dz = cat(d[2], [sh_d[l][2] for l in range(L)])
            tb = cat(jnp.where(active, jnp.float32(_INF), 0.0),
                     [jnp.where(pend_ok[l], pend_dist[l], 0.0)
                      for l in range(L)])
            tg = cat(jnp.full((R,), -2.0, jnp.float32),
                     [jnp.where(pend_ok[l], light_mtl_f[l], -2.0)
                      for l in range(L)])
            t_all, pnx_a, pny_a, pnz_a, tcu_a, tcv_a, mtl_a, em_a = (
                fused_trace_planes(scene, ox, oy, oz, dx, dy, dz, config,
                                   t_bound=tb, target_mtl=tg)
            )
            hit_all = mtl_a >= 0.0
            ray_count = ray_count + active.astype(jnp.float32)
            for l in range(L):
                ray_count = ray_count + pend_ok[l].astype(jnp.float32)

            # --- resolve LAST iteration's NEE with this trace's shadow legs
            for l in range(L):
                sl = slice((1 + l) * R, (2 + l) * R)
                if config.shadow_test == "mtl":
                    vis = mtl_a[sl] == light_mtl_f[l]  # miss -1 / killed -3
                else:
                    occ = (mtl_a[sl] == -3.0) | (
                        (mtl_a[sl] >= 0.0)
                        & (t_all[sl] < pend_dist[l] - 1e-3)
                    )
                    vis = ~occ
                add = pend_ok[l] & vis
                accum = (
                    accum[0] + jnp.where(add, pend_c[l][0] * inv_spp, 0.0),
                    accum[1] + jnp.where(add, pend_c[l][1] * inv_spp, 0.0),
                    accum[2] + jnp.where(add, pend_c[l][2] * inv_spp, 0.0),
                )

            # --- shade the bounce leg (all attributes straight from the
            # trace)
            t = t_all[:R]
            m = mtl_a[:R]                            # material id as f32
            hit = hit_all[:R]
            point = vec.add(o, vec.scale(d, t))
            pn = vec.normalize((pnx_a[:R], pny_a[:R], pnz_a[:R]))

            hit_emissive = hit & (em_a[:R] > 0.5)
            include = (ray_type == CAMERA) | (ray_type == TRANSMISSION)
            emit = active & hit_emissive & include
            mat = _material_planes(scene, m)
            mrad = mat["rad"]
            rad = (
                rad[0] + jnp.where(emit, thr[0] * mrad[0], 0.0),
                rad[1] + jnp.where(emit, thr[1] * mrad[1], 0.0),
                rad[2] + jnp.where(emit, thr[2] * mrad[2], 0.0),
            )
            shade_mask = active & hit & ~hit_emissive

            kd_val = _tex_kd(scene, mat, tcu_a[:R], tcv_a[:R], mat["kd"])
            ks = mat["ks"]
            ns = mat["ns"]
            wi = vec.neg(d)

            # --- per-(path, bounce) uniforms: 4 per light for NEE + 5 for
            # RR/BSDF, all derived from the lane's path key + bounce index
            # (bitwise scheduling-independent, see module docstring).
            # Planar counter-based threefry (ops/rng.py) instead of
            # vmap(fold_in) + per-lane uniform((4L+5,)).
            draws = bounce_uniforms(pkd[0], pkd[1], bounce, 4 * L + 5)

            # --- queue THIS bounce's NEE (resolves next iteration)
            # pre-scale by throughput: the pending term is final once visible
            new_pend_ok, new_pend_c, new_pend_dist = [], [], []
            new_sh_o, new_sh_d = [], []
            up = vec.splat(jnp.asarray([0.0, 0.0, 1.0]), shape)
            for l in range(L):
                wo, contrib, distl, okl = _nee_geometry(
                    scene, config, l, point, pn, wi, kd_val, ks, ns,
                    draws[4 * l + 0], draws[4 * l + 1],
                    draws[4 * l + 2], draws[4 * l + 3],
                    shade_mask,
                )
                new_pend_ok.append(okl)
                new_pend_c.append(vec.mul(thr, contrib))
                new_pend_dist.append(distl)
                # park non-pending shadow lanes (see bounce-leg parking)
                new_sh_o.append(vec.where(okl, point, far3))
                new_sh_d.append(vec.where(okl, wo, up))
            sh_o = tuple(new_sh_o)
            pend_ok = tuple(new_pend_ok)
            pend_c = tuple(new_pend_c)
            pend_dist = tuple(new_pend_dist)
            sh_d = tuple(new_sh_d)

            # --- Russian roulette + BSDF continuation
            u = [draws[4 * L + i] for i in range(5)]
            survive = shade_mask & (u[0] < config.p_rr) & (bounce + 1 < config.max_depth)
            new_dir, new_type = sample_bsdf_planar(
                d, pn, mat["kd"], ks, ns, mat["ni"],
                u[1], u[2], u[3], u[4],
            )
            alive_next = survive & (new_type != INVALID)

            if config.specular_weight == "ref":
                ds_weight = kd_val
            else:
                ds_weight = vec.where((new_type == SPECULAR), ks, kd_val)
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
            d = vec.where(alive_next, new_dir,
                          vec.splat(jnp.asarray([0.0, 0.0, 1.0]), shape))
            ray_type = jnp.where(alive_next, new_type, ray_type)
            bounce = bounce + 1

            # --- finished paths: emissive radiance into the lane accumulator
            finished = active & ~alive_next
            accum = (
                accum[0] + jnp.where(finished, rad[0] * inv_spp, 0.0),
                accum[1] + jnp.where(finished, rad[1] * inv_spp, 0.0),
                accum[2] + jnp.where(finished, rad[2] * inv_spp, 0.0),
            )
            active = alive_next

            return (it + 1, active, samples_done, bounce, o, d, ray_type,
                    thr, rad, accum, sh_o, sh_d, pend_ok, pend_c, pend_dist,
                    pkd, ray_count)

        zero = jnp.zeros(shape, jnp.float32)
        one = jnp.ones(shape, jnp.float32)
        z3 = (zero, zero, zero)
        up = vec.splat(jnp.asarray([0.0, 0.0, 1.0]), shape)
        farp = jnp.full(shape, _FAR, jnp.float32)
        state = (
            jnp.int32(0),
            jnp.zeros(shape, bool),              # active
            jnp.zeros(shape, jnp.int32),         # samples_done
            jnp.zeros(shape, jnp.int32),         # bounce
            z3,                                  # o
            up,                                  # d
            jnp.full(shape, CAMERA, jnp.int32),  # ray_type
            (one, one, one),                     # throughput
            z3,                                  # radiance (emissive terms)
            z3,                                  # accum
            tuple((farp, farp, farp) for _ in range(L)),  # sh_o (parked)
            tuple(up for _ in range(L)),         # sh_d
            tuple(jnp.zeros(shape, bool) for _ in range(L)),   # pend_ok
            tuple(z3 for _ in range(L)),         # pend_c
            tuple(zero for _ in range(L)),       # pend_dist
            (jnp.zeros(shape, jnp.uint32),
             jnp.zeros(shape, jnp.uint32)),      # per-lane path key planes
            zero,                                # per-lane ray counter (f32)
        )
        state = jax.lax.while_loop(cond, body, state)
        accum, ray_count = state[9], state[-1]
        img = jax.lax.dynamic_update_slice(
            img, jnp.stack(accum, axis=-1), (e * R, 0)
        )
        return img, rays_traced + jnp.sum(ray_count)

    img = jnp.zeros((n_epochs * R, 3), jnp.float32)
    img, rays_traced = jax.lax.fori_loop(
        0, n_epochs, epoch, (img, jnp.float32(0.0))
    )
    return img, rays_traced


def _whole_image(scene, cam, key, config, spp, lanes):
    img, rays = render_fused(scene, cam, key, config, spp, lanes)
    W, H = cam.width, cam.height
    # slot order -> pixel order: one gather, once per render
    _, inv = pixel_tile_order(W, H)
    return img[jnp.asarray(inv)].reshape(H, W, 3), rays


@partial(jax.jit, static_argnames=("config", "spp", "lanes"))
def render_fused_jit(scene, cam, key, config, spp, lanes=262144):
    return _whole_image(scene, cam, key, config, spp, lanes)[0]


@partial(jax.jit, static_argnames=("config", "spp", "lanes"))
def render_fused_stats_jit(scene, cam, key, config, spp, lanes=262144):
    return _whole_image(scene, cam, key, config, spp, lanes)
