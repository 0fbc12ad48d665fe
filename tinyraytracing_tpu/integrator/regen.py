"""Regeneration wavefront: ray compaction with static shapes.

The fixed-depth scan in wavefront.py pays every bounce for every lane even
though Russian roulette (P=0.8) and misses kill most paths early — the
expected path length is ~4 bounces but the scan runs max_depth (16) waves.
Path tracers compact live rays between bounces; with static shapes the
equivalent is PATH REGENERATION: a fixed pool of R
lanes, and whenever a lane's path terminates it immediately starts the
next (pixel, sample) path from the global queue. Lanes stay ~fully
occupied; the loop runs until the sample queue is drained and all lanes
finished — ~total_paths * E[len] / R iterations instead of spp * max_depth.

Completed paths scatter-add their radiance into the image by pixel id
(functional scatter — the reference's racy shared `image[p] += color`,
main.cpp:103-108, replaced by a deterministic data-parallel scatter).

Estimator semantics are IDENTICAL to wavefront.trace (same NEE / RR / BSDF
per-bounce math); only the scheduling and the RNG stream mapping differ
(keys are derived from the global path id, so the result is deterministic
for a given key but not bitwise-equal to the scan renderer).

NOTE: built on lax.while_loop, so this path is for FORWARD rendering only
(not reverse-differentiable); gradients use the fixed-depth scan.

DISPOSITION: superseded as a production scheduler by the queue-fed fused
renderer (integrator/fused_queue.py — same global-queue idea over the
trace of ops/trace.py). Retained deliberately as a statistical cross-check
ORACLE: it shares no trace code with the fused paths, so agreement within
MC bounds (tests/test_integrator.py) is independent evidence the fast path
computes the same estimator.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tinyraytracing_tpu.config import CAMERA, INVALID, RenderConfig, TRANSMISSION
from tinyraytracing_tpu.integrator.bsdf import sample_bsdf
from tinyraytracing_tpu.integrator.nee import direct_light
from tinyraytracing_tpu.models.camera import Camera, camera_basis
from tinyraytracing_tpu.ops.intersect import intersect
from tinyraytracing_tpu.ops.linalg import normalize


def render_regen(
    scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    lanes: int = 131072,
    max_iters: int | None = None,
):
    """Render (H, W, 3) with the regeneration wavefront. ``lanes`` is the
    resident path-pool size; ``max_iters`` bounds the loop (default sized
    from the expected path length with generous slack)."""
    W, H = cam.width, cam.height
    n_pix = W * H
    total_paths = n_pix * spp
    R = min(lanes, total_paths)
    if max_iters is None:
        # E[len] <= 1/(1-p_rr) + NEE decay; slack 3x + drain tail
        max_iters = int(total_paths / R * (1.0 / (1.0 - config.p_rr)) * 3) + config.max_depth + 8

    eye, horizontal, vertical, llc = camera_basis(cam)
    inv_spp = jnp.float32(1.0 / spp)

    def intersect_fn(o, dd):
        return intersect(scene, o, dd, config)

    def camera_ray(path_id):
        """(org, dir) for path ids (R,) — jitter from counter-based bits."""
        pix = path_id // spp
        i = (pix // W).astype(jnp.float32)
        j = (pix % W).astype(jnp.float32)
        # per-path jitter from counter-based key bits (one threefry pass)
        bits = jax.random.key_data(jax.vmap(
            lambda t: jax.random.fold_in(key, t))(path_id))
        h1 = (bits[..., 0].astype(jnp.uint32) >> 8).astype(jnp.float32) / jnp.float32(1 << 24)
        h2 = (bits[..., 1].astype(jnp.uint32) >> 8).astype(jnp.float32) / jnp.float32(1 << 24)
        x = j / (W - 1.0) + (h1 - 0.5) / W
        y = (H - i) / (H - 1.0) + (h2 - 0.5) / H
        d = (
            llc[None, :]
            + x[:, None] * horizontal[None, :]
            + y[:, None] * vertical[None, :]
            - eye[None, :]
        )
        d = normalize(d)
        return jnp.broadcast_to(eye, d.shape), d

    L = scene.light_mtl.shape[0]

    def cond(state):
        it, counter, active, *_ = state
        return (it < max_iters) & (jnp.any(active) | (counter < total_paths))

    def body(state):
        (it, counter, active, path_id, bounce, org, d, ray_type,
         throughput, radiance, img, rays_traced) = state

        # --- regenerate dead lanes from the queue
        dead = ~active
        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1      # rank among dead
        new_id = counter + rank
        can = dead & (new_id < total_paths)
        path_id = jnp.where(can, new_id, path_id)
        norg, nd = camera_ray(jnp.maximum(path_id, 0))
        org = jnp.where(can[:, None], norg, org)
        d = jnp.where(can[:, None], nd, d)
        ray_type = jnp.where(can, CAMERA, ray_type)
        throughput = jnp.where(can[:, None], 1.0, throughput)
        radiance = jnp.where(can[:, None], 0.0, radiance)
        bounce = jnp.where(can, 0, bounce)
        active = active | can
        counter = counter + jnp.sum(dead.astype(jnp.int32))
        counter = jnp.minimum(counter, total_paths)

        # --- one bounce (same math as wavefront.trace)
        kb = jax.random.fold_in(jax.random.fold_in(key, 2), it)
        ks_ = lambda i: jax.random.fold_in(kb, i)

        hit = intersect_fn(org, d)
        idx = hit.idx
        m = scene.tri_mtl[idx]
        point = org + hit.t[:, None] * d

        hit_emissive = hit.hit & scene.tri_emissive[idx]
        include = (ray_type == CAMERA) | (ray_type == TRANSMISSION)
        radiance = radiance + jnp.where(
            (active & hit_emissive & include)[:, None],
            throughput * scene.radiance[m], 0.0,
        )
        shade_mask = active & hit.hit & ~hit_emissive

        w = hit.w
        pn = normalize(
            scene.n0[idx] * w[:, None]
            + scene.n1[idx] * hit.u[:, None]
            + scene.n2[idx] * hit.v[:, None]
        )
        tid = scene.tex_id[m]
        has_tex = tid >= 0
        tid_safe = jnp.maximum(tid, 0)
        col = scene.t0[idx, 0] * w + scene.t1[idx, 0] * hit.u + scene.t2[idx, 0] * hit.v
        row = scene.t0[idx, 1] * w + scene.t1[idx, 1] * hit.u + scene.t2[idx, 1] * hit.v
        icol = col - jnp.floor(col)
        irow = row - jnp.floor(row)
        th = scene.tex_hw[tid_safe, 0]
        tw = scene.tex_hw[tid_safe, 1]
        r_ix = jnp.clip((irow * th).astype(jnp.int32), 0, th - 1)
        c_ix = jnp.clip((icol * tw).astype(jnp.int32), 0, tw - 1)
        kd_val = jnp.where(
            has_tex[:, None], scene.tex[tid_safe, r_ix, c_ix], scene.kd[m]
        )

        wi = -d
        nee_u = jax.random.uniform(ks_(0), (org.shape[0], L, 4), dtype=jnp.float32)
        l_dir = direct_light(
            scene, config, intersect_fn,
            point, pn, wi, kd_val, scene.ks[m], scene.ns[m], nee_u,
        )
        radiance = radiance + jnp.where(shade_mask[:, None], throughput * l_dir, 0.0)

        u = jax.random.uniform(ks_(1), (5, org.shape[0]), dtype=jnp.float32)
        survive = shade_mask & (u[0] < config.p_rr) & (bounce + 1 < config.max_depth)
        new_dir, new_type = sample_bsdf(
            d, pn, scene.kd[m], scene.ks[m], scene.ns[m], scene.ni[m],
            u[1], u[2], u[3], u[4],
        )
        valid = new_type != INVALID
        alive_next = survive & valid

        if config.specular_weight == "ref":
            ds_weight = kd_val
        else:
            from tinyraytracing_tpu.config import SPECULAR
            ds_weight = jnp.where((new_type == SPECULAR)[:, None], scene.ks[m], kd_val)
        weight = jnp.where((new_type == TRANSMISSION)[:, None], scene.tr[m], ds_weight)
        throughput = jnp.where(
            alive_next[:, None], throughput * weight / config.p_rr, throughput
        )
        org = jnp.where(alive_next[:, None], point, org)
        d = jnp.where(alive_next[:, None], new_dir, jnp.array([0.0, 0.0, 1.0]))
        ray_type = jnp.where(alive_next, new_type, ray_type)
        bounce = bounce + 1

        # --- completed paths scatter into the image
        finished = active & ~alive_next
        pix = jnp.where(finished, path_id // spp, 0)
        contrib = jnp.where(finished[:, None], radiance * inv_spp, 0.0)
        img = img.at[pix].add(contrib)
        rays_traced = rays_traced + (
            jnp.sum(active.astype(jnp.int32)) + L * jnp.sum(shade_mask.astype(jnp.int32))
        ).astype(jnp.float32)
        active = alive_next

        return (it + 1, counter, active, path_id, bounce, org, d,
                ray_type, throughput, radiance, img, rays_traced)

    z3 = jnp.zeros((R, 3), jnp.float32)
    state = (
        jnp.int32(0),
        jnp.int32(0),
        jnp.zeros((R,), bool),
        jnp.zeros((R,), jnp.int32),
        jnp.zeros((R,), jnp.int32),
        z3,
        jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (R, 1)),
        jnp.full((R,), CAMERA, jnp.int32),
        jnp.ones((R, 3), jnp.float32),
        z3,
        jnp.zeros((n_pix, 3), jnp.float32),
        jnp.float32(0.0),  # ray counter: f32 total avoids int32 overflow at >2^31 rays
    )
    state = jax.lax.while_loop(cond, body, state)
    img = state[-2]
    rays_traced = state[-1]
    return img.reshape(H, W, 3), rays_traced


@partial(jax.jit, static_argnames=("config", "spp", "lanes"))
def render_regen_jit(scene, cam, key, config, spp, lanes=131072):
    return render_regen(scene, cam, key, config, spp, lanes)[0]


@partial(jax.jit, static_argnames=("config", "spp", "lanes"))
def render_regen_stats_jit(scene, cam, key, config, spp, lanes=131072):
    return render_regen(scene, cam, key, config, spp, lanes)


def render_persistent(
    scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    lanes: int = 262144,
    max_iters: int | None = None,
):
    """Pixel-persistent wavefront: lane l serves pixel (epoch*R + l) and
    runs all ``spp`` of its samples back to back, accumulating radiance in a
    LANE-LOCAL register. The epoch's accumulator block is then written into
    the image DENSELY (dynamic_update_slice) — no scatter anywhere.

    Rationale: the regeneration renderer above scatters every iteration
    (``img.at[pix].add``) because its global path queue maps lanes to
    arbitrary pixels, and the scatter-add pays per index, including the
    many lanes contributing zeros. Binding pixels to lanes trades it for a
    free dense write, at the cost of tail idling (a lane that finishes its spp early
    waits for the epoch's stragglers — sample-length variance averages out
    over spp, so occupancy stays high).

    Same per-bounce estimator as wavefront.trace / render_regen (NEE + RR +
    quirk flags); RNG keyed by global path id => deterministic.
    """
    W, H = cam.width, cam.height
    n_pix = W * H
    R = min(lanes, n_pix)
    n_epochs = -(-n_pix // R)
    if max_iters is None:
        # per-epoch bound: spp samples x expected length, 3x slack
        max_iters = int(spp * (1.0 / (1.0 - config.p_rr)) * 3) + config.max_depth + 8

    eye, horizontal, vertical, llc = camera_basis(cam)
    inv_spp = jnp.float32(1.0 / spp)
    L = scene.light_mtl.shape[0]

    def intersect_fn(o, dd):
        return intersect(scene, o, dd, config)

    def camera_ray(path_id):
        pix = path_id // spp
        i = (pix // W).astype(jnp.float32)
        j = (pix % W).astype(jnp.float32)
        bits = jax.random.key_data(jax.vmap(
            lambda t: jax.random.fold_in(key, t))(path_id))
        h1 = (bits[..., 0].astype(jnp.uint32) >> 8).astype(jnp.float32) / jnp.float32(1 << 24)
        h2 = (bits[..., 1].astype(jnp.uint32) >> 8).astype(jnp.float32) / jnp.float32(1 << 24)
        x = j / (W - 1.0) + (h1 - 0.5) / W
        y = (H - i) / (H - 1.0) + (h2 - 0.5) / H
        d = (
            llc[None, :]
            + x[:, None] * horizontal[None, :]
            + y[:, None] * vertical[None, :]
            - eye[None, :]
        )
        return jnp.broadcast_to(eye, d.shape), normalize(d)

    def epoch(e, carry):
        img, rays_traced = carry
        lane = jnp.arange(R, dtype=jnp.int32)
        pixel = e * R + lane                       # may exceed n_pix - 1
        in_range = pixel < n_pix

        def cond(s):
            it, active, samples_done, *_ = s
            return (it < max_iters) & (jnp.any(active) | jnp.any(
                in_range & (samples_done < spp)))

        def body(s):
            (it, active, samples_done, bounce, org, d, ray_type,
             throughput, radiance, accum, rays_traced) = s

            # start the next sample on lanes whose path has terminated
            can = ~active & in_range & (samples_done < spp)
            path_id = jnp.where(can, pixel * spp + samples_done, 0)
            norg, nd = camera_ray(path_id)
            org = jnp.where(can[:, None], norg, org)
            d = jnp.where(can[:, None], nd, d)
            ray_type = jnp.where(can, CAMERA, ray_type)
            throughput = jnp.where(can[:, None], 1.0, throughput)
            radiance = jnp.where(can[:, None], 0.0, radiance)
            bounce = jnp.where(can, 0, bounce)
            samples_done = samples_done + can.astype(jnp.int32)
            active = active | can

            kb = jax.random.fold_in(jax.random.fold_in(key, 2), e * max_iters + it)
            ks_ = lambda i: jax.random.fold_in(kb, i)

            hit = intersect_fn(org, d)
            idx = hit.idx
            m = scene.tri_mtl[idx]
            point = org + hit.t[:, None] * d

            hit_emissive = hit.hit & scene.tri_emissive[idx]
            include = (ray_type == CAMERA) | (ray_type == TRANSMISSION)
            radiance = radiance + jnp.where(
                (active & hit_emissive & include)[:, None],
                throughput * scene.radiance[m], 0.0,
            )
            shade_mask = active & hit.hit & ~hit_emissive

            w = hit.w
            pn = normalize(
                scene.n0[idx] * w[:, None]
                + scene.n1[idx] * hit.u[:, None]
                + scene.n2[idx] * hit.v[:, None]
            )
            tid = scene.tex_id[m]
            has_tex = tid >= 0
            tid_safe = jnp.maximum(tid, 0)
            col = scene.t0[idx, 0] * w + scene.t1[idx, 0] * hit.u + scene.t2[idx, 0] * hit.v
            row = scene.t0[idx, 1] * w + scene.t1[idx, 1] * hit.u + scene.t2[idx, 1] * hit.v
            icol = col - jnp.floor(col)
            irow = row - jnp.floor(row)
            th = scene.tex_hw[tid_safe, 0]
            tw = scene.tex_hw[tid_safe, 1]
            r_ix = jnp.clip((irow * th).astype(jnp.int32), 0, th - 1)
            c_ix = jnp.clip((icol * tw).astype(jnp.int32), 0, tw - 1)
            kd_val = jnp.where(
                has_tex[:, None], scene.tex[tid_safe, r_ix, c_ix], scene.kd[m]
            )

            wi = -d
            nee_u = jax.random.uniform(ks_(0), (R, L, 4), dtype=jnp.float32)
            l_dir = direct_light(
                scene, config, intersect_fn,
                point, pn, wi, kd_val, scene.ks[m], scene.ns[m], nee_u,
            )
            radiance = radiance + jnp.where(shade_mask[:, None], throughput * l_dir, 0.0)

            u = jax.random.uniform(ks_(1), (5, R), dtype=jnp.float32)
            survive = shade_mask & (u[0] < config.p_rr) & (bounce + 1 < config.max_depth)
            new_dir, new_type = sample_bsdf(
                d, pn, scene.kd[m], scene.ks[m], scene.ns[m], scene.ni[m],
                u[1], u[2], u[3], u[4],
            )
            valid = new_type != INVALID
            alive_next = survive & valid

            if config.specular_weight == "ref":
                ds_weight = kd_val
            else:
                from tinyraytracing_tpu.config import SPECULAR
                ds_weight = jnp.where((new_type == SPECULAR)[:, None], scene.ks[m], kd_val)
            weight = jnp.where((new_type == TRANSMISSION)[:, None], scene.tr[m], ds_weight)
            throughput = jnp.where(
                alive_next[:, None], throughput * weight / config.p_rr, throughput
            )
            org = jnp.where(alive_next[:, None], point, org)
            d = jnp.where(alive_next[:, None], new_dir, jnp.array([0.0, 0.0, 1.0]))
            ray_type = jnp.where(alive_next, new_type, ray_type)
            bounce = bounce + 1

            finished = active & ~alive_next
            accum = accum + jnp.where(finished[:, None], radiance * inv_spp, 0.0)
            rays_traced = rays_traced + (
                jnp.sum(active.astype(jnp.int32)) + L * jnp.sum(shade_mask.astype(jnp.int32))
            ).astype(jnp.float32)
            active = alive_next
            return (it + 1, active, samples_done, bounce, org, d,
                    ray_type, throughput, radiance, accum, rays_traced)

        z3 = jnp.zeros((R, 3), jnp.float32)
        state = (
            jnp.int32(0),
            jnp.zeros((R,), bool),
            jnp.zeros((R,), jnp.int32),
            jnp.zeros((R,), jnp.int32),
            z3,
            jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (R, 1)),
            jnp.full((R,), CAMERA, jnp.int32),
            jnp.ones((R, 3), jnp.float32),
            z3,
            z3,                       # per-lane pixel accumulator
            rays_traced,
        )
        state = jax.lax.while_loop(cond, body, state)
        accum, rays_traced = state[-2], state[-1]
        img = jax.lax.dynamic_update_slice(img, accum, (e * R, 0))
        return img, rays_traced

    # pad the flat image so every epoch's dense R-row write stays in bounds
    img = jnp.zeros((n_epochs * R, 3), jnp.float32)
    rt0 = jnp.float32(0.0)  # per-step counts are exact int32; f32 total avoids int32 overflow at >2^31 rays
    img, rays_traced = jax.lax.fori_loop(0, n_epochs, epoch, (img, rt0))
    return img[:n_pix].reshape(H, W, 3), rays_traced


@partial(jax.jit, static_argnames=("config", "spp", "lanes"))
def render_persistent_jit(scene, cam, key, config, spp, lanes=262144):
    return render_persistent(scene, cam, key, config, spp, lanes)[0]


@partial(jax.jit, static_argnames=("config", "spp", "lanes"))
def render_persistent_stats_jit(scene, cam, key, config, spp, lanes=262144):
    return render_persistent(scene, cam, key, config, spp, lanes)
