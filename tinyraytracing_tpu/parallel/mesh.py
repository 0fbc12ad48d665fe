"""Device-mesh sharded rendering.

Parallelism inventory (SURVEY.md §2 checklist):

1. **tile axis** — pixels (rays) sharded across devices; each device owns a
   contiguous slice of the pixel space and traces its rays against the
   replicated scene/BVH (the axis the reference's dead algo.hpp
   parallelized, RT/algo.hpp:298).
2. **spp axis** — sample passes sharded; the per-device partial sums are
   combined with ``lax.psum`` — a deterministic tree reduction replacing the
   reference's racy shared ``image[p] += color`` (main.cpp:103-108).

Scene, camera, and key are replicated (in_spec P()); the output image comes
back tile-sharded and is reassembled by jit.

Multi-host: call ``jax.distributed.initialize()`` first; the same code runs
with a mesh spanning hosts (geometry replicated per host, psum across
devices).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.integrator.wavefront import trace
from tinyraytracing_tpu.models.camera import Camera, generate_rays_for_pixels
from tinyraytracing_tpu.models.scene import Scene


def make_mesh(n_tile: int | None = None, n_spp: int | None = None, devices=None) -> Mesh:
    """2-D Mesh over the available devices. Defaults: all devices on the
    tile axis (ray-parallel), spp axis 1."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_tile is None and n_spp is None:
        n_tile, n_spp = n, 1
    elif n_tile is None:
        n_tile = n // n_spp
    elif n_spp is None:
        n_spp = n // n_tile
    if n_tile * n_spp != n:
        raise ValueError(f"mesh {n_tile}x{n_spp} != {n} devices")
    arr = np.asarray(devices).reshape(n_tile, n_spp)
    return Mesh(arr, ("tile", "spp"))


def _shard_body(scene, cam, key, pix, spp_ids, config: RenderConfig, spp: int):
    """Per-device: trace |pix| rays for each of the local spp ids, psum over
    the spp axis. Runs under shard_map."""
    tile_i = jax.lax.axis_index("tile")
    spp_i = jax.lax.axis_index("spp")

    def one_pass(acc, s):
        # fold (sample, tile, spp) into the key: every (pass, device) gets
        # an independent counter-based stream.
        k = jax.random.fold_in(key, s)
        k = jax.random.fold_in(k, tile_i)
        k_ray, k_trace = jax.random.split(k)
        o, d = generate_rays_for_pixels(cam, pix, k_ray)
        rad = trace(scene, o, d, k_trace, config)
        rad = jnp.where(s < spp, rad, 0.0)  # padded spp ids contribute 0
        return acc + rad, None

    acc0 = jnp.zeros((pix.shape[0], 3), jnp.float32)
    acc, _ = jax.lax.scan(one_pass, acc0, spp_ids)
    acc = jax.lax.psum(acc, "spp")
    return acc / spp


@partial(jax.jit, static_argnames=("config", "spp", "mesh"))
def _render_sharded_jit(scene, cam, key, config, spp, mesh):
    from jax import shard_map  # jax>=0.8 top-level API (experimental.shard_map is deprecated)

    W, H = cam.width, cam.height
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]

    n_pix = W * H
    pad_pix = (-n_pix) % n_tile
    pix = jnp.arange(n_pix + pad_pix, dtype=jnp.int32)
    pix = jnp.minimum(pix, n_pix - 1)

    pad_spp = (-spp) % n_spp
    spp_ids = jnp.arange(spp + pad_spp, dtype=jnp.int32)

    fn = shard_map(
        partial(_shard_body, config=config, spp=spp),
        mesh=mesh,
        in_specs=(P(), P(), P(), P("tile"), P("spp")),
        out_specs=P("tile"),
        check_vma=False,
    )
    img = fn(scene, cam, key, pix, spp_ids)
    return img[:n_pix].reshape(H, W, 3)


def render_sharded(
    scene: Scene,
    cam: Camera,
    key,
    config: RenderConfig,
    mesh: Mesh | None = None,
    spp: int | None = None,
):
    """Distributed render over ``mesh``; returns the (H, W, 3) linear mean
    image (replicated)."""
    if mesh is None:
        mesh = make_mesh()
    return _render_sharded_jit(scene, cam, key, config, spp or config.spp, mesh)


# ---------------------------------------------------------------------------
# sharded FUSED renderer (the fast path)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("config", "spp", "mesh", "lanes"))
def _render_fused_sharded_jit(scene, cam, key, config, spp, mesh, lanes):
    """Tile-shard the fused pixel-persistent renderer: every device runs its
    own epochs over a contiguous range of image-tile SLOTS (32x32 pixel
    tiles, integrator.fused.pixel_tile_order) against the replicated scene,
    then the slot images are reassembled. The fused renderer's RNG is
    path-indexed, so the result is BITWISE equal to the single-device
    render for any mesh shape when both compile the same per-device lane
    count (tests/test_parallel.py)."""
    from jax import shard_map  # jax>=0.8 top-level API (experimental.shard_map is deprecated)

    from tinyraytracing_tpu.integrator.fused import (
        pixel_tile_order,
        render_fused,
    )

    W, H = cam.width, cam.height
    n_pix = W * H
    D = mesh.devices.size
    n_slots_dev = -(-n_pix // (128 * D)) * 128       # 128-aligned per device
    lanes_dev = min(lanes, n_slots_dev)

    def body(scene, cam, key):
        tile_i = jax.lax.axis_index("tile")
        img, rays = render_fused(
            scene, cam, key, config, spp,
            lanes=lanes_dev,
            slot_base=tile_i * n_slots_dev,
            n_slots=n_slots_dev,
        )
        return img[:n_slots_dev], jax.lax.psum(rays, "tile")

    flat_mesh = Mesh(mesh.devices.reshape(-1), ("tile",))
    fn = shard_map(
        body,
        mesh=flat_mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P("tile"), P()),
        check_vma=False,
    )
    img_slots, rays = fn(scene, cam, key)
    _, inv = pixel_tile_order(W, H)
    img = img_slots[jnp.asarray(inv)].reshape(H, W, 3)
    return img, rays


def render_fused_sharded(
    scene: Scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    mesh: Mesh | None = None,
    lanes: int = 262144,
):
    """Multi-chip fused render; returns ((H, W, 3) image, traced rays)."""
    if mesh is None:
        mesh = make_mesh()
    return _render_fused_sharded_jit(scene, cam, key, config, spp, mesh, lanes)


# ---------------------------------------------------------------------------
# sharded QUEUE renderer (the auto-picked path for non-trivial scenes)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("config", "spp", "mesh", "lanes"))
def _render_queue_sharded_jit(scene, cam, key, config, spp, mesh, lanes):
    """Shard the GLOBAL PATH QUEUE of the queue-fed fused renderer: device
    i serves queue slice [i*per, (i+1)*per) of the W*H*spp paths (tile
    order, so each device's refills stay spatially coherent), renders into
    its own (n_pix, 3) partial image, and the partials are psum'd. The
    path-indexed RNG makes every path's radiance independent of which
    device traces it; only the float add order differs from a
    single-device render (allclose, not bitwise — fused_queue docstring).
    """
    from jax import shard_map

    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue

    W, H = cam.width, cam.height
    total = W * H * spp
    D = mesh.devices.size
    per = -(-total // D)
    lanes_dev = min(lanes, per)

    def body(scene, cam, key):
        i = jax.lax.axis_index("tile")
        img, rays = render_fused_queue(
            scene, cam, key, config, spp,
            lanes=lanes_dev, path_lo=i * per, n_paths=per,
        )
        return jax.lax.psum(img, "tile"), jax.lax.psum(rays, "tile")

    flat_mesh = Mesh(mesh.devices.reshape(-1), ("tile",))
    fn = shard_map(
        body,
        mesh=flat_mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    img, rays = fn(scene, cam, key)
    return img.reshape(H, W, 3), rays


def render_queue_sharded(
    scene: Scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    mesh: Mesh | None = None,
    lanes: int = 262144,
):
    """Multi-chip queue-fed fused render (path-queue sharding); returns
    ((H, W, 3) image, traced rays)."""
    if mesh is None:
        mesh = make_mesh()
    return _render_queue_sharded_jit(scene, cam, key, config, spp, mesh, lanes)


# ---------------------------------------------------------------------------
# sharded FAST GRADIENT path (custom-VJP fused trace, diff/fast.py)
# ---------------------------------------------------------------------------

def render_loss_fast_sharded(params, scene, cam, key, target,
                             config: RenderConfig, spp: int,
                             mesh: Mesh | None = None):
    """Tile-sharded fast-path MSE loss: device i renders+differentiates
    pixels [i*per, (i+1)*per) through diff/fast.render_diff (the custom-
    VJP fused trace) against the replicated scene, and the squared-error
    partial sums are ``psum``'d INSIDE the mapped body — so under
    ``jax.grad`` the parameter gradients are all-reduced inside the same
    program, where XLA's scheduler can overlap the collective with the
    remaining backward. Numerically equals the single-device
    ``diff.fast.render_loss_fast`` (pixel values are partition-
    independent via the path-indexed RNG; only the reduction order of the
    scalar loss differs).
    """
    from jax import shard_map

    from tinyraytracing_tpu.diff.fast import render_diff
    from tinyraytracing_tpu.diff.inverse import apply_params

    if mesh is None:
        mesh = make_mesh()
    W, H = cam.width, cam.height
    n_pix = W * H
    flat_mesh = Mesh(mesh.devices.reshape(-1), ("tile",))
    D = flat_mesh.devices.size
    per = -(-n_pix // D)
    tgt = target.reshape(n_pix, 3)
    pad = D * per - n_pix
    if pad:
        tgt = jnp.pad(tgt, ((0, pad), (0, 0)))

    def body(params, scene, cam, key, tgt_slice):
        i = jax.lax.axis_index("tile")
        s2, c2 = apply_params(scene, cam, params)
        img = render_diff(s2, c2, key, config, spp,
                          pix_lo=i * per, n_pix_local=per)
        idx = i * per + jnp.arange(per, dtype=jnp.int32)
        w = (idx < n_pix).astype(jnp.float32)[:, None]   # drop pad pixels
        err = jnp.sum(((img - tgt_slice) ** 2) * w)
        return jax.lax.psum(err, "tile") / (n_pix * 3)

    fn = shard_map(
        body,
        mesh=flat_mesh,
        in_specs=(P(), P(), P(), P(), P("tile")),
        out_specs=P(),
        check_vma=False,
    )
    return fn(params, scene, cam, key, tgt)


# ---------------------------------------------------------------------------
# sharded CHUNKED queue driver (checkpoint/resume across devices)
# ---------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=("config", "spp", "lanes", "n_paths_dev", "mesh"),
)
def _queue_init_sharded(scene, cam, key, config, spp, lanes, n_paths_dev,
                        mesh):
    """Initial queue state with a leading device axis, built INSIDE a
    shard_map program so its leaves have the exact buffer layout the chunk
    step produces (feeding host-constructed arrays into the compiled step
    across repeated render invocations trips dispatch-cache buffer
    mismatches on jax 0.9)."""
    from jax import shard_map

    from tinyraytracing_tpu.integrator.fused_queue import _queue_setup

    def body(scene, cam, key):
        _, _, init_state, _, _ = _queue_setup(
            scene, cam, key, config, spp, lanes, 0, n_paths_dev
        )
        return jax.tree.map(lambda x: jnp.asarray(x)[None], init_state())

    flat_mesh = Mesh(mesh.devices.reshape(-1), ("tile",))
    example = jax.eval_shape(
        lambda: body(scene, cam, key)
    )
    spec = jax.tree.map(
        lambda x: P(*(("tile",) + (None,) * (x.ndim - 1))), example
    )
    fn = shard_map(
        body, mesh=flat_mesh, in_specs=(P(), P(), P()), out_specs=spec,
        check_vma=False,
    )
    return fn(scene, cam, key)


@partial(
    jax.jit,
    static_argnames=("config", "spp", "lanes", "n_paths_dev", "mesh"),
)
def _queue_chunk_sharded_step(scene, cam, key, state, stop, config, spp,
                              lanes, n_paths_dev, mesh):
    """One host chunk of the sharded queue loop: every device advances its
    own queue slice by up to ``stop - it`` iterations. ``state`` is the
    single-device queue state with a leading device axis on every leaf,
    sharded P("tile")."""
    from jax import shard_map

    from tinyraytracing_tpu.integrator.fused_queue import _queue_setup

    def body(scene, cam, key, state, stop):
        i = jax.lax.axis_index("tile")
        st = jax.tree.map(lambda x: x[0], state)
        _, _, _, cond, bod = _queue_setup(
            scene, cam, key, config, spp, lanes, i * n_paths_dev, n_paths_dev
        )
        st = jax.lax.while_loop(lambda s: cond(s) & (s[0] < stop), bod, st)
        return jax.tree.map(lambda x: x[None], st)

    flat_mesh = Mesh(mesh.devices.reshape(-1), ("tile",))
    # full-rank per-leaf specs (leading device axis sharded, rest
    # replicated) — a bare P("tile") on rank-2/3 leaves trips resharding
    # when the previous chunk's committed output flows back in
    state_spec = jax.tree.map(
        lambda x: P(*(("tile",) + (None,) * (x.ndim - 1))), state
    )
    fn = shard_map(
        body,
        mesh=flat_mesh,
        in_specs=(P(), P(), P(), state_spec, P()),
        out_specs=state_spec,
        check_vma=False,
    )
    return fn(scene, cam, key, state, stop)


def render_queue_sharded_chunked(
    scene: Scene,
    cam: Camera,
    key,
    config: RenderConfig,
    spp: int,
    mesh: Mesh | None = None,
    lanes: int = 262144,
    target_chunk_s: float = 8.0,
    checkpoint_path: str | None = None,
    checkpoint_every_s: float = 120.0,
    resume: bool = False,
    progress=None,
    stop_after_chunks: int | None = None,
):
    """Host-chunked MULTI-DEVICE queue render — the single-device chunked
    driver's checkpoint/resume applied to the path-queue-sharded renderer.
    Math identical to
    ``render_queue_sharded`` (chunk boundaries just pause each device's
    while_loop); the full per-device lane state is checkpointable between
    chunks exactly like the single-device chunked driver.

    ``stop_after_chunks``: graceful preemption — stop after that many
    host chunks, snapshotting to ``checkpoint_path`` (kept, not cleared)
    so a ``resume=True`` call continues the render.

    Returns ((H, W, 3) image, traced rays f32).
    """
    import time

    from tinyraytracing_tpu.integrator.fused_queue import _queue_setup
    from tinyraytracing_tpu.ops.rng import master_key_data
    from tinyraytracing_tpu.utils import checkpoint as ckpt

    if mesh is None:
        mesh = make_mesh()
    W, H = cam.width, cam.height
    total = W * H * spp
    D = mesh.devices.size
    per = -(-total // D)
    lanes_dev = min(lanes, per)

    _, max_iters, init_state, _, _ = _queue_setup(
        scene, cam, key, config, spp, lanes_dev, 0, per
    )
    flat_mesh = Mesh(mesh.devices.reshape(-1), ("tile",))

    def _place(tree):
        # commit every leaf to its device-axis sharding up front so chunk
        # calls never hit input-resharding edge cases
        return jax.tree.map(
            lambda x: jax.device_put(
                x,
                jax.NamedSharding(
                    flat_mesh, P(*(("tile",) + (None,) * (x.ndim - 1)))
                ),
            ),
            tree,
        )

    def _replicate(tree):
        # fully-committed replicated placement for the non-sharded args —
        # mixing committed and uncommitted inputs across repeated calls
        # trips a resharding misalignment in the jit fast path (observed
        # on jax 0.9 CPU: a scalar matched against a P('tile', None)
        # expectation on the second render invocation)
        rep = jax.NamedSharding(flat_mesh, P())
        return jax.tree.map(lambda x: jax.device_put(x, rep), tree)

    scene = _replicate(scene)
    cam = _replicate(cam)
    key = _replicate(key)

    state = _queue_init_sharded(
        scene, cam, key, config=config, spp=spp, lanes=lanes_dev,
        n_paths_dev=per, mesh=mesh,
    )
    treedef = jax.tree_util.tree_structure(state)
    meta = dict(spp=spp, lanes=lanes_dev, n_devices=D, n_paths=per,
                W=W, H=H, key=np.asarray(master_key_data(key)),
                config=repr(config), scene_tris=scene.num_triangles,
                scene_vsum=ckpt.scene_checksum(scene),
                state_version=ckpt.QUEUE_STATE_VERSION,
                treedef=str(treedef))
    if resume and checkpoint_path:
        leaves = ckpt.load_queue_state(checkpoint_path, meta)
        if leaves is not None and len(leaves) == treedef.num_leaves:
            state = _place(jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(x) for x in leaves]
            ))

    # every chunk advances all still-running devices to the same ``stop``;
    # a device whose queue slice drains exits its while_loop below the
    # stop and is marked done (its `it` freezes) — the loop ends when all
    # devices are done, not when the first one is
    its = np.asarray(state[0])
    running = np.ones(D, bool)
    chunk = 4
    chunks_done = 0
    preempted = False
    last_ckpt = time.perf_counter()
    while running.any() and int(its[running].min()) < max_iters:
        if stop_after_chunks is not None and chunks_done >= stop_after_chunks:
            preempted = True
            if checkpoint_path:
                ckpt.save_queue_state(checkpoint_path, state, meta)
            break
        stop = int(its[running].min()) + chunk
        t0 = time.perf_counter()
        step_args = (
            scene, cam, key, state,
            jax.device_put(jnp.int32(stop), jax.NamedSharding(flat_mesh, P())),
        )
        kw = dict(config=config, spp=spp, lanes=lanes_dev, n_paths_dev=per,
                  mesh=mesh)
        try:
            state = _queue_chunk_sharded_step(*step_args, **kw)
        except (ValueError, IndexError) as e:  # pragma: no cover - jax quirk
            # jax 0.9's dispatch fast path can misalign cached input-buffer
            # expectations across repeated render invocations interleaved
            # with other shard_map programs ("Execution supplied N buffers
            # but compiled program expected M"). Recompiling from a clean
            # cache is always correct — do that once and retry.
            if "buffers" not in str(e) and "index out of range" not in str(e):
                raise
            _queue_chunk_sharded_step.clear_cache()
            state = _queue_chunk_sharded_step(*step_args, **kw)
        its = np.asarray(state[0])
        dt = time.perf_counter() - t0
        running = its >= stop
        if progress is not None:
            progress(it=int(its.max()), counter=int(np.asarray(state[1]).min()),
                     seconds=dt)
        per_it = dt / max(chunk, 1)
        chunk = max(1, min(chunk * 4, int(target_chunk_s / max(per_it, 1e-4))))
        chunks_done += 1
        if checkpoint_path and time.perf_counter() - last_ckpt > checkpoint_every_s:
            ckpt.save_queue_state(checkpoint_path, state, meta)
            last_ckpt = time.perf_counter()
    if checkpoint_path and not preempted:
        ckpt.clear_queue_state(checkpoint_path)
    img = jnp.stack(
        [jnp.sum(pl, axis=0) for pl in state[-2]], axis=-1
    ).reshape(H, W, 3)
    rays = jnp.sum(state[-1])
    return img, rays
