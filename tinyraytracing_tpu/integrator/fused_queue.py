"""Queue-fed fused wavefront — the flagship renderer for non-trivial scenes.

The pixel-persistent scheduler (integrator/fused.py) binds lane == pixel,
which makes accumulation a free dense write but forbids work stealing: as
paths die at random, live lanes thin out, and by the epoch tail an
iteration traces batches that are mostly parked lanes.

This renderer restores the GLOBAL PATH QUEUE of regen.py (a dead lane
immediately starts the next (pixel, sample) from the queue, so occupancy
stays ~100% and the loop runs ~total_work/R iterations), combined with
everything the fused generation added:

- the trace (ops/trace.py): closest hit plus interpolated shading
  attributes in one call;
- component-planar state, select-chain material/light lookups (large
  light tables use one fused-row matmul — integrator/fused._nee_geometry);
- path-indexed counter RNG: every draw is a pure function of
  (path_id, bounce) via planar threefry (ops/rng.py);
- dead-lane ranking via a matmul prefix sum (ops/scan.py);
- dead/masked rays parked at origin 1e30 so they fail the root AABB test;
- queue order == 32x32 image-tile order (integrator.fused.pixel_tile_order)
  with consecutive path ids covering the same pixel's samples, so lane
  refills keep neighbouring lanes spatially coherent.

NEE is IMMEDIATE (not deferred): each iteration traces twice — bounce
rays, then the L shadow-ray groups of this bounce's shading points — and
finished paths scatter-add their radiance into the image by pixel id.

CHUNKED EXECUTION: ``render_fused_queue_chunked`` runs the SAME loop body
but caps each device program at a host-chosen number of iterations
(adapted to wall time), carrying the full lane state between calls. Chunk
boundaries do not change any math — the state is identical to pausing the
while_loop — so images are bitwise-equal to the one-shot renderer. The
chunked state is the checkpoint: it is saved/loaded between chunks for
resumable long renders (utils/checkpoint.py, ``cli.py --checkpoint``).

Estimator semantics identical to wavefront.trace / regen renderers
(reference RayTracingOnCPU/pathTracing.cpp:3-102 NEE + RR + quirk flags).
Same key => same image (determinism test); unlike the persistent renderer
the image is not bitwise-invariant to lane-count changes (scatter-add
order into a pixel depends on scheduling), so sharded runs agree to float
addition reorder, not bitwise.

Forward-only (lax.while_loop); gradients use diff/fast.py's fixed-depth
planar renderer over the SAME trace (custom-VJP path replay).
"""

from __future__ import annotations

import time
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
    _FAR,
    _material_planes,
    _nee_geometry,
    _tex_kd,
    pixel_tile_order,
    sample_bsdf_planar,
)
from tinyraytracing_tpu.models.camera import Camera, camera_basis
from tinyraytracing_tpu.ops import vec
from tinyraytracing_tpu.ops.rng import (
    bits_to_uniform,
    bounce_uniforms,
    master_key_data,
    path_keys,
)
from tinyraytracing_tpu.ops.scan import prefix_sum_lanes
from tinyraytracing_tpu.ops.sort import sort_planes_by

_INF = jnp.float32(3.0e38)

def _queue_setup(scene, cam, key, config, spp, lanes, path_lo, n_paths,
                 max_iters=None):
    """Build (R, max_iters, init_state, cond, body) for the queue loop.

    Shared by the one-shot renderer (tests, CPU, sharding wrappers) and
    the chunked driver so both run the exact same iteration body. An
    explicit ``max_iters`` REPLACES the auto-computed cap (a caller
    raising it for unlucky long-RR renders must not be silently clamped).
    """
    W, H = cam.width, cam.height
    n_pix = W * H
    total_all = n_pix * spp
    if n_paths is None:
        n_paths = total_all
    R = min(lanes, n_paths)
    R = -(-R // 128) * 128
    if max_iters is None:
        max_iters = int(
            n_paths / R * (1.0 / (1.0 - config.p_rr)) * 3
        ) + config.max_depth + 9

    order_np = pixel_tile_order(W, H)[0]
    order = jnp.asarray(order_np)
    eye, horizontal, vertical, llc = camera_basis(cam)
    inv_spp = jnp.float32(1.0 / spp)
    L = scene.light_mtl.shape[0]
    light_mtl_f = [scene.light_mtl[l].astype(jnp.float32) for l in range(L)]
    shape = (R,)
    key_data = master_key_data(key)
    resort_every = config.queue_resort_every
    resort_key = config.queue_resort_key
    n_nodes = scene.bvh.n_nodes if scene.bvh is not None else 0
    if resort_every < 0:   # auto (config.queue_resort_every)
        resort_every = 0
        if scene.num_triangles >= 10_000:
            resort_key = "morton"
            resort_every = 1 if n_nodes > 4096 else 2
    # scene AABB for the morton resort key (static, from the root node)
    if scene.bvh is not None:
        aabb_lo = jax.lax.stop_gradient(scene.bvh.nmin[0])
        aabb_inv = 1.0 / jnp.maximum(scene.bvh.nmax[0] - scene.bvh.nmin[0],
                                     1e-6)
    else:
        aabb_lo = jnp.zeros(3, jnp.float32)
        aabb_inv = jnp.ones(3, jnp.float32)

    eye = tuple(eye[k] for k in range(3))
    horizontal = tuple(horizontal[k] for k in range(3))
    vertical = tuple(vertical[k] for k in range(3))
    llc = tuple(llc[k] for k in range(3))

    from tinyraytracing_tpu.ops.trace import (
        fused_trace_planes,
        occlusion_trace_segmented,
    )

    def camera_ray(path_id):
        pix = order[jnp.clip(path_id // spp, 0, n_pix - 1)]
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
        return o, d, (pk0, pk1), pix

    def cond(s):
        it, counter, active = s[0], s[1], s[2]
        return (it < max_iters) & (jnp.any(active) | (counter < n_paths))

    def body(s):
        (it, counter, active, path_id, pix, bounce, o, d, ray_type, thr,
         rad, pkd, img, ray_count) = s

        # --- optional periodic resort by path id (see config.queue_resort_every)
        if resort_every > 0:
            def resort(args):
                (active, path_id, pix, bounce, o, d, ray_type, thr, rad,
                 pkd, ray_count) = args
                if resort_key == "morton":
                    # spatial re-formation: sort lanes by a 15-bit morton
                    # code of the ray ORIGIN (32^3 cells over the scene
                    # AABB) — neighbouring lanes then hold spatially-local
                    # rays regardless of path age. Camera lanes all share
                    # the eye origin, so the stable sort keeps their
                    # (coherent) relative order.
                    _MB = config.morton_cells

                    def q5(c, k):
                        x = (o[k] - aabb_lo[k]) * aabb_inv[k]
                        return jnp.clip((x * _MB).astype(jnp.int32), 0,
                                        _MB - 1)

                    qx, qy, qz = q5(0, 0), q5(1, 1), q5(2, 2)

                    def spread(b):
                        b = (b | (b << 16)) & 0x30000FF
                        b = (b | (b << 8)) & 0x300F00F
                        b = (b | (b << 4)) & 0x30C30C3
                        b = (b | (b << 2)) & 0x9249249
                        return b

                    key_ = (spread(qx) | (spread(qy) << 1)
                            | (spread(qz) << 2))
                elif resort_key == "path_octant":
                    # sub-sort 8192-path blocks by direction octant, making
                    # neighbouring lanes homogeneous in both origin region
                    # (block) and direction signs (octant).
                    # Path ids are rebased to the active window's minimum
                    # before keying: live ids span at most ~max_depth*R,
                    # so the shifted key always fits int32 (a raw path_id
                    # >= 2^28 — e.g. 4096x4096 @ 16 spp — would overflow
                    # and scramble the sort on exactly the huge renders
                    # the resort targets)
                    octant = (
                        (d[0] < 0).astype(jnp.int32)
                        + 2 * (d[1] < 0).astype(jnp.int32)
                        + 4 * (d[2] < 0).astype(jnp.int32)
                    )
                    base = jnp.min(
                        jnp.where(active, path_id, jnp.int32(2**31 - 1))
                    )
                    rel = jnp.maximum(path_id - base, 0)
                    key_ = ((rel >> 13) << 16) + (octant << 13) + (
                        rel & 8191
                    )
                else:
                    key_ = path_id
                key_ = jnp.where(active, key_, jnp.int32(2**31 - 1))
                # ONE BROADCAST-KEY stable sort moves every state plane
                # with the key: payloads are stacked into a (C, R) f32
                # matrix (non-f32 planes bitcast — payload operands are
                # never compared, only moved) and the key row-broadcast,
                # so each row sorts by identical keys and stability gives
                # every row the SAME permutation — the stable-argsort
                # order (ops/sort.py).
                s = sort_planes_by(key_, (
                    active, path_id, pix, bounce,
                    o[0], o[1], o[2], d[0], d[1], d[2], ray_type,
                    thr[0], thr[1], thr[2], rad[0], rad[1], rad[2],
                    pkd[0], pkd[1], ray_count,
                ))
                return (s[0], s[1], s[2], s[3], (s[4], s[5], s[6]),
                        (s[7], s[8], s[9]), s[10], (s[11], s[12], s[13]),
                        (s[14], s[15], s[16]), (s[17], s[18]), s[19])

            args = (active, path_id, pix, bounce, o, d, ray_type, thr,
                    rad, pkd, ray_count)
            args = jax.lax.cond(
                it % resort_every == 0, resort, lambda a: a, args
            )
            (active, path_id, pix, bounce, o, d, ray_type, thr, rad,
             pkd, ray_count) = args

        # --- regenerate dead lanes from the global queue (tile order)
        dead = ~active
        if config.queue_refill == "row":
            # refill only rows that died completely: rows then always hold
            # 128 consecutive tile-order paths (see config.queue_refill)
            row_dead = jnp.all(dead.reshape(-1, 128), axis=1)
            elig = jnp.broadcast_to(row_dead[:, None], (R // 128, 128)).reshape(-1)
        else:
            elig = dead
        rank = prefix_sum_lanes(elig) - 1
        new_id = counter + rank
        # second clause: under sharding the last device's queue slice may
        # extend past the global path count — those ids must never start
        can = elig & (new_id < n_paths) & (path_lo + new_id < total_all)
        path_id = jnp.where(can, new_id, path_id)
        norg, nd, npk, npix = camera_ray(path_lo + jnp.maximum(path_id, 0))
        o = vec.where(can, norg, o)
        d = vec.where(can, nd, d)
        pkd = (jnp.where(can, npk[0], pkd[0]),
               jnp.where(can, npk[1], pkd[1]))
        pix = jnp.where(can, npix, pix)
        ray_type = jnp.where(can, CAMERA, ray_type)
        one = jnp.ones(shape, jnp.float32)
        zero = jnp.zeros(shape, jnp.float32)
        thr = vec.where(can, (one, one, one), thr)
        rad = vec.where(can, (zero, zero, zero), rad)
        bounce = jnp.where(can, 0, bounce)
        active = active | can
        counter = jnp.minimum(
            counter + jnp.sum(elig.astype(jnp.int32)), n_paths
        )

        far = jnp.full(shape, _FAR, jnp.float32)
        far3 = (far, far, far)
        o = vec.where(active, o, far3)

        # --- trace 1: bounce rays (dead lanes bound at 0: instant prune)
        t, pnx, pny, pnz, tcu, tcv, mtl, em = fused_trace_planes(
            scene, o[0], o[1], o[2], d[0], d[1], d[2], config,
            t_bound=jnp.where(active, jnp.float32(_INF), 0.0),
        )
        hit = mtl >= 0.0
        ray_count = ray_count + active.astype(jnp.float32)

        m = mtl
        point = vec.add(o, vec.scale(d, t))
        pn = vec.normalize((pnx, pny, pnz))

        hit_emissive = hit & (em > 0.5)
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

        kd_val = _tex_kd(scene, mat, tcu, tcv, mat["kd"])
        ks = mat["ks"]
        ns = mat["ns"]
        wi = vec.neg(d)

        # --- per-(path, bounce) uniforms (path-indexed counter RNG)
        draws = bounce_uniforms(pkd[0], pkd[1], bounce, 4 * L + 5)

        # --- trace 2: this bounce's L shadow-ray groups, immediate NEE
        pend = []
        sh_o, sh_d = [], []
        up = vec.splat(jnp.asarray([0.0, 0.0, 1.0]), shape)
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
        # shadow t-bound = the light distance: the walk prunes everything
        # beyond the light from its first node visit (pending lanes), and
        # bound 0 parks the rest outright
        occl_q = config.shadow_test == "mtl"
        if not pend:
            st = smtl = svis = None
        elif occl_q:
            # the occlusion query (visibility only) with per-light
            # live-lane compaction on big trees
            # (ops/trace.occlusion_trace_segmented)
            svis = occlusion_trace_segmented(
                scene,
                cat([s[0] for s in sh_o]), cat([s[1] for s in sh_o]),
                cat([s[2] for s in sh_o]),
                cat([s[0] for s in sh_d]), cat([s[1] for s in sh_d]),
                cat([s[2] for s in sh_d]),
                cat([jnp.where(okl, distl, 0.0)
                     for (okl, _, distl) in pend]),
                cat([jnp.where(okl, light_mtl_f[l], -2.0)
                     for l, (okl, _, _) in enumerate(pend)]),
                config, L,
            )
        else:
            st, _, _, _, _, _, smtl, _ = fused_trace_planes(
                scene,
                cat([s[0] for s in sh_o]), cat([s[1] for s in sh_o]),
                cat([s[2] for s in sh_o]),
                cat([s[0] for s in sh_d]), cat([s[1] for s in sh_d]),
                cat([s[2] for s in sh_d]),
                config,
                t_bound=cat([jnp.where(okl, distl, 0.0)
                             for (okl, _, distl) in pend]),
                # a hit of another material inside the bound occludes
                # (ops/trace._resolve)
                target_mtl=cat([jnp.where(okl, light_mtl_f[l], -2.0)
                                for l, (okl, _, _) in enumerate(pend)]),
                attrs=False,   # visibility only: skip the attribute gathers
            )
        for l, (okl, contrib, distl) in enumerate(pend):
            sl = slice(l * R, (l + 1) * R)
            if occl_q:
                # reference visibility (pathTracing.cpp:55-58) decomposed:
                # some target-material hit at the bound AND not occluded
                vis = svis[sl] > 0.5
            else:
                occ = (smtl[sl] == -3.0) | (
                    (smtl[sl] >= 0.0) & (st[sl] < distl - 1e-3)
                )
                vis = ~occ
            add = okl & vis
            rad = (
                rad[0] + jnp.where(add, thr[0] * contrib[0], 0.0),
                rad[1] + jnp.where(add, thr[1] * contrib[1], 0.0),
                rad[2] + jnp.where(add, thr[2] * contrib[2], 0.0),
            )
            ray_count = ray_count + okl.astype(jnp.float32)

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
        d = vec.where(alive_next, new_dir, up)
        ray_type = jnp.where(alive_next, new_type, ray_type)
        bounce = bounce + 1

        # --- finished paths scatter into the image by pixel id. The image
        # is carried as THREE FLAT (n_pix,) planes rather than one
        # (n_pix, 3) array whose 3-wide minor dimension pads badly.
        finished = active & ~alive_next
        spix = jnp.where(finished, pix, n_pix)       # out-of-range = dropped
        img = tuple(
            img[k].at[spix].add(
                jnp.where(finished, rad[k] * inv_spp, 0.0), mode="drop"
            )
            for k in range(3)
        )
        active = alive_next

        return (it + 1, counter, active, path_id, pix, bounce, o, d,
                ray_type, thr, rad, pkd, img, ray_count)

    def init_state():
        zero = jnp.zeros(shape, jnp.float32)
        one = jnp.ones(shape, jnp.float32)
        z3 = (zero, zero, zero)
        up0 = vec.splat(jnp.asarray([0.0, 0.0, 1.0]), shape)
        return (
            jnp.int32(0),
            jnp.int32(0),                        # queue counter
            jnp.zeros(shape, bool),              # active
            jnp.zeros(shape, jnp.int32),         # path_id
            jnp.zeros(shape, jnp.int32),         # pixel
            jnp.zeros(shape, jnp.int32),         # bounce
            z3,                                  # o
            up0,                                 # d
            jnp.full(shape, CAMERA, jnp.int32),  # ray_type
            (one, one, one),                     # throughput
            z3,                                  # radiance
            (jnp.zeros(shape, jnp.uint32),
             jnp.zeros(shape, jnp.uint32)),      # path key planes
            tuple(jnp.zeros((n_pix,), jnp.float32)
                  for _ in range(3)),            # image planes (pixel order)
            zero,                                # per-lane ray counter
        )

    return R, max_iters, init_state, cond, body


def render_fused_queue(
    scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    lanes: int = 262144,
    max_iters: int | None = None,
    path_lo=0,
    n_paths: int | None = None,
):
    """Render with the queue-fed fused wavefront (one device program).

    Returns ((n_pix, 3) flat linear image in PIXEL order, traced-ray count
    f32). ``path_lo`` (may be traced — a shard offset) and ``n_paths``
    (static) select a slice of the global path queue [0, W*H*spp) for
    tile-sharded multi-chip rendering; path id p covers sample (p % spp)
    of pixel order[p // spp]. The CUDA trace needs ``scene.bvh``.

    One device program from start to end; ``render_fused_queue_chunked``
    runs the same loop in host chunks with checkpoint/resume.
    """
    _, _, init_state, cond, body = _queue_setup(
        scene, cam, key, config, spp, lanes, path_lo, n_paths,
        max_iters=max_iters,
    )
    state = jax.lax.while_loop(cond, body, init_state())
    img, ray_count = jnp.stack(state[-2], axis=-1), state[-1]
    return img, jnp.sum(ray_count)


@partial(
    jax.jit,
    static_argnames=("config", "spp", "lanes", "n_paths"),
    donate_argnums=(3,),
)
def _queue_chunk(scene, cam, key, state, stop, path_lo, config, spp,
                 lanes, n_paths):
    """Run the queue loop until ``stop`` iterations (traced) or done."""
    _, _, _, cond, body = _queue_setup(
        scene, cam, key, config, spp, lanes, path_lo, n_paths
    )
    return jax.lax.while_loop(
        lambda s: cond(s) & (s[0] < stop), body, state
    )


@partial(jax.jit, static_argnames=("config", "spp", "lanes", "n_paths"))
def _queue_init(scene, cam, key, config, spp, lanes, n_paths):
    _, _, init_state, _, _ = _queue_setup(
        scene, cam, key, config, spp, lanes, 0, n_paths
    )
    return init_state()


def render_fused_queue_chunked(
    scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    lanes: int = 262144,
    target_chunk_s: float = 8.0,
    checkpoint_path: str | None = None,
    checkpoint_every_s: float = 120.0,
    resume: bool = False,
    progress=None,
    path_lo: int = 0,
    n_paths: int | None = None,
    stop_after_chunks: int | None = None,
):
    """Host-chunked queue render: bitwise-identical to the one-shot loop,
    run as device programs of ~``target_chunk_s`` each so the lane state
    can be saved between them. Returns ((n_pix, 3) image, rays f32).

    With ``checkpoint_path`` the full lane state is snapshotted every
    ``checkpoint_every_s`` and on completion removed; ``resume=True``
    restarts from the snapshot if present. The snapshot meta binds the
    PRNG key, the full RenderConfig, scene identity, and the state-layout
    version/treedef — any mismatch rejects the snapshot (fresh start)
    rather than resuming a different stream.

    ``stop_after_chunks``: graceful preemption — stop after that many
    chunks, snapshotting to ``checkpoint_path`` (kept, not cleared), and
    return the partial image.
    """
    from tinyraytracing_tpu.utils import checkpoint as ckpt

    R, max_iters, _, _, _ = _queue_setup(
        scene, cam, key, config, spp, lanes, path_lo, n_paths
    )
    state = _queue_init(scene, cam, key, config, spp, lanes, n_paths)
    treedef = jax.tree_util.tree_structure(state)
    # the meta dict binds the snapshot to EVERYTHING that determines the
    # stream: PRNG key, full render config, scene identity (triangle count
    # + vertex checksum), state-layout version + treedef signature. A
    # resume with any mismatch (different --seed, quirk flags, a different
    # same-resolution scene, or a layout change between versions) is
    # rejected instead of silently mixing streams.
    meta = dict(spp=spp, lanes=lanes, path_lo=path_lo,
                n_paths=n_paths if n_paths is not None else -1,
                W=cam.width, H=cam.height,
                key=np.asarray(master_key_data(key)),
                config=repr(config),
                scene_tris=scene.num_triangles,
                scene_vsum=ckpt.scene_checksum(scene),
                state_version=ckpt.QUEUE_STATE_VERSION,
                treedef=str(treedef))
    if resume and checkpoint_path:
        leaves = ckpt.load_queue_state(checkpoint_path, meta)
        if leaves is not None and len(leaves) == treedef.num_leaves:
            state = jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(x) for x in leaves]
            )

    it = int(state[0])
    chunk = 4
    chunks_done = 0
    preempted = False
    last_ckpt = time.perf_counter()
    while True:
        if stop_after_chunks is not None and chunks_done >= stop_after_chunks:
            preempted = True
            break
        t0 = time.perf_counter()
        state = _queue_chunk(
            scene, cam, key, state, jnp.int32(it + chunk), path_lo,
            config, spp, lanes, n_paths,
        )
        it_new = int(state[0])         # syncs the chunk
        dt = time.perf_counter() - t0
        did = it_new - it
        it = it_new
        chunks_done += 1
        if progress is not None:
            progress(it=it, counter=int(state[1]), seconds=dt)
        if did < chunk or it >= max_iters:
            break
        # adapt chunk size to the wall-time target (growth-capped so the
        # compile-inflated first measurement cannot overshoot it)
        per = dt / max(did, 1)
        chunk = max(1, min(chunk * 4, int(target_chunk_s / max(per, 1e-4))))
        if checkpoint_path and time.perf_counter() - last_ckpt > checkpoint_every_s:
            ckpt.save_queue_state(checkpoint_path, state, meta)
            last_ckpt = time.perf_counter()
    if checkpoint_path and preempted:
        ckpt.save_queue_state(checkpoint_path, state, meta)
    elif checkpoint_path:
        ckpt.clear_queue_state(checkpoint_path)
    img, ray_count = jnp.stack(state[-2], axis=-1), state[-1]
    return img, jnp.sum(ray_count)


@partial(jax.jit, static_argnames=("config", "spp", "lanes"))
def render_fused_queue_jit(scene, cam, key, config, spp, lanes=262144):
    img, _ = render_fused_queue(scene, cam, key, config, spp, lanes)
    return img.reshape(cam.height, cam.width, 3)


@partial(jax.jit, static_argnames=("config", "spp", "lanes"))
def render_fused_queue_stats_jit(scene, cam, key, config, spp, lanes=262144):
    img, rays = render_fused_queue(scene, cam, key, config, spp, lanes)
    return img.reshape(cam.height, cam.width, 3), rays
