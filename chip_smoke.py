#!/usr/bin/env python3
"""Smoke test of the path tracer on NVIDIA GPUs, through its user entry points.

Run from the root of a checkout:

    python3 chip_smoke.py            # phases 1-4 on one GPU
    python3 chip_smoke.py --multi    # the sharded renderers on four GPUs

Phases (one process, one GPU):

1. CLI render: ``cli.main`` on the cornell box, 512x512 at 16 spp (the
   persistent renderer); the PNG must be written and the image finite and
   non-black.
2. Queue renderer: ``render_image`` on ``quad_grid(100_000)`` at 1280x720,
   4 spp (the host-chunked driver), once straight through and once
   preempted after one chunk and resumed from its checkpoint; the two
   images must agree to float32 reordering of the scatter-add.
3. Gradients: ``jax.value_and_grad(render_loss_fast)`` on the cornell box at
   512x512, 4 spp, for kd, vertex_offset and eye, then one optax Adam step.
4. The CUDA trace kernel against the plain XLA path on the card: 262,144
   random rays on the cornell box and on the 100K-triangle grid (closest
   hit with attributes, occlusion), phase 1's image and phase 3's kd
   gradient rendered both ways, and the time of each.

``--multi`` runs only the sharded checks on a 4-GPU mesh: the fused
renderer (bitwise against one GPU), the queue renderer one-shot and
chunked (float-reorder tolerance), and the sharded loss and gradients.

The script exits non-zero without a result unless JAX runs on a GPU. Its
last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 262_144


def _decode_png(path):
    """(H, W, 3) uint8 of a PNG written by io/image.write_png (8-bit RGB,
    filter 0 on every row)."""
    import numpy as np

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all(), "unexpected PNG row filter"
    return rows[:, 1:].reshape(h, w, 3)


def _timed(fn, *args, reps=3):
    """(result, best wall seconds of ``reps`` warm calls); the first call
    compiles and is not timed."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def _cornell(width=512, height=512):
    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.models.procedural import cornell_box
    from tinyraytracing_tpu.ops.bvh import attach_bvh

    scene, cam = cornell_box(width=width, height=height)
    return attach_bvh(scene, RenderConfig()), cam


def _grid(width=1280, height=720):
    from tinyraytracing_tpu.models.procedural import quad_grid

    return quad_grid(100_000, width=width, height=height)


def phase_cli(tmp):
    """Phase 1: the CLI, persistent renderer. Returns the float image."""
    import jax
    import numpy as np

    from tinyraytracing_tpu import cli
    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.integrator.fused import render_fused_jit
    from tinyraytracing_tpu.io.image import tonemap_srgb

    out = os.path.join(tmp, "cornell.png")
    t0 = time.perf_counter()
    rc = cli.main(["--scene", "cornell", "--width", "512", "--height", "512",
                   "--spp", "16", "--out", out])
    dt = time.perf_counter() - t0
    assert rc == 0 and os.path.getsize(out) > 0, "CLI wrote no PNG"
    png = _decode_png(out)
    assert png.shape == (512, 512, 3), png.shape
    # the same render as a float image: the CLI's own config and seed 0
    scene, cam = _cornell()
    img = np.asarray(render_fused_jit(scene, cam, jax.random.PRNGKey(0),
                                      RenderConfig(spp=16), 16))
    assert np.isfinite(img).all(), "non-finite pixels"
    assert img.mean() > 0.01 and (png > 0).mean() > 0.5, "image is black"
    same = (tonemap_srgb(img) == png).mean()
    assert same > 0.999, f"PNG differs from the float render ({same})"
    print(f"phase 1 cli: {dt:.2f}s incl. compile, mean {img.mean():.5f}, "
          f"png==render on {same:.6f} of values")
    return img


def phase_queue(tmp):
    """Phase 2: queue renderer, chunked, with preempt + resume."""
    import jax
    import numpy as np

    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.integrator.fused_queue import (
        render_fused_queue_chunked,
    )
    from tinyraytracing_tpu.render import render_image

    scene, cam = _grid()
    cfg = RenderConfig()
    ck = os.path.join(tmp, "queue_state.npz")
    t0 = time.perf_counter()
    full = render_image(scene, cam, cfg, spp=4, renderer="queue",
                        checkpoint_path=ck)
    t_first = time.perf_counter() - t0
    assert not os.path.exists(ck), "finished render left its checkpoint"
    assert full.shape == (720, 1280, 3) and np.isfinite(full).all()
    assert full.mean() > 0.01, "queue image is black"
    part = []
    render_fused_queue_chunked(
        scene, cam, jax.random.PRNGKey(0), cfg, 4, checkpoint_path=ck,
        stop_after_chunks=1, progress=lambda **kw: part.append(kw["it"]),
    )
    assert os.path.exists(ck), "preempted render left no checkpoint"
    resumed_its = []
    t0 = time.perf_counter()
    res = render_image(scene, cam, cfg, spp=4, renderer="queue",
                       checkpoint_path=ck, resume=True,
                       progress=lambda **kw: resumed_its.append(kw["it"]))
    t_resume = time.perf_counter() - t0
    assert resumed_its[0] > part[-1], "resume restarted from scratch"
    again = render_image(scene, cam, cfg, spp=4, renderer="queue")
    # The finished paths of an iteration are scatter-added into the image;
    # on the GPU the adds into one pixel run in a varying order (atomics),
    # so two renders of the same key — resumed or not — agree to float32
    # reordering of a pixel's few sample sums, not bitwise.
    for tag, x in (("resumed", res), ("second uninterrupted", again)):
        err = float(np.abs(x - full).max())
        print(f"phase 2 queue: {tag} vs first render: max |diff| {err:.3g}, "
              f"{(x != full).mean():.6f} of values differ")
        np.testing.assert_allclose(x, full, rtol=2e-5, atol=2e-5)
    print(f"phase 2 queue: grid100K 1280x720 4spp first render {t_first:.2f}s "
          f"(incl. compile), preempted at iteration {part[-1]}, resumed "
          f"render {t_resume:.2f}s, {len(resumed_its)} chunks, "
          f"mean {full.mean():.5f}")


def _grad_setup():
    import jax.numpy as jnp

    from tinyraytracing_tpu.diff.inverse import SceneParams

    scene, cam = _cornell()
    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
    params = SceneParams.init_from(scene, cam, "kd", "vertex_offset", "eye")
    return scene, cam, target, params


def _value_and_grad(cfg, spp=4):
    """jit(value_and_grad) of the fast-path loss; call as f(params, scene,
    cam, target) so the scene is an argument, not a baked-in constant."""
    import jax

    from tinyraytracing_tpu.diff.fast import render_loss_fast

    key = jax.random.PRNGKey(0)
    return jax.jit(jax.value_and_grad(
        lambda p, s, c, t: render_loss_fast(p, s, c, key, t, cfg, spp)
    ))


def phase_grad():
    """Phase 3: value_and_grad + one Adam step. Returns the kd gradient."""
    import jax
    import numpy as np
    import optax

    from tinyraytracing_tpu.config import RenderConfig

    scene, cam, target, params = _grad_setup()
    vg = _value_and_grad(RenderConfig(max_depth=8))
    t0 = time.perf_counter()
    loss, g = jax.block_until_ready(vg(params, scene, cam, target))
    dt = time.perf_counter() - t0
    opt = optax.adam(0.01)
    state = opt.init(params)
    updates, state = opt.update(g, state, params)
    new = optax.apply_updates(params, updates)
    leaves = jax.tree_util.tree_leaves(g) + jax.tree_util.tree_leaves(new)
    assert np.isfinite(float(loss)), "loss not finite"
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves), "grads not finite"
    kd = np.asarray(g.kd)
    assert np.abs(kd).sum() > 0, "kd gradients vanished"
    print(f"phase 3 grad: loss {float(loss):.6g}, |dL/dkd| {np.abs(kd).sum():.6g}, "
          f"|dL/dvertex| {np.abs(np.asarray(g.vertex_offset)).sum():.6g}, "
          f"|dL/deye| {np.abs(np.asarray(g.eye)).sum():.6g}, "
          f"{dt:.2f}s incl. compile, Adam step applied")
    return kd


def _random_rays(rng, n):
    import jax.numpy as jnp
    import numpy as np

    org = rng.uniform([0, 0, -400], [556, 548, 559], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a: [jnp.asarray(a[:, k], jnp.float32) for k in range(3)]
    return f(org) + f(d)


def _shadow_rays(rng, scene, n):
    """Shadow queries: points in the box toward sampled points on light 0,
    bound = that distance, target = the light's material."""
    import jax.numpy as jnp
    import numpy as np

    org = rng.uniform([1, 1, 1], [555, 547, 558], (n, 3))
    lv = [np.asarray(t[0, 0], np.float64) for t in
          (scene.lt_v0, scene.lt_v1, scene.lt_v2)]
    b = rng.uniform(0, 1, (n, 3))
    b /= b.sum(1, keepdims=True)
    p = b[:, :1] * lv[0] + b[:, 1:2] * lv[1] + b[:, 2:] * lv[2]
    to = p - org
    dist = np.linalg.norm(to, axis=1)
    d = to / dist[:, None]
    f = lambda a: [jnp.asarray(a[:, k], jnp.float32) for k in range(3)]
    tg = jnp.full((n,), float(scene.light_mtl[0]), jnp.float32)
    return f(org) + f(d), jnp.asarray(dist, jnp.float32), tg


def _compare_trace(name, scene, rng, report):
    """Closest hit + occlusion, kernel vs plain XLA, on N_RAYS rays."""
    import jax
    import numpy as np

    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.ops.trace import fused_trace_planes

    rays = _random_rays(rng, N_RAYS)
    outs, times = {}, {}
    for trace in ("cuda", "xla"):
        cfg = RenderConfig(trace=trace)
        fn = lambda *r, cfg=cfg: fused_trace_planes(
            scene, *r, cfg, return_tri=True)
        out, times[trace] = _timed(fn, *rays)
        outs[trace] = [np.asarray(x) for x in out]
    k, x = outs["cuda"], outs["xla"]
    hk, hx = k[6] >= 0, x[6] >= 0
    both = hk & hx
    same_tri = both & (k[8] == x[8])
    # FMA contraction and summation order differ between nvcc's code and
    # XLA's, and the kernel visits nodes near-first while the plain walk
    # goes in preorder: a ray that grazes a box or a triangle edge, or two
    # hits inside the emissive tie band (4e-6 relative), may resolve
    # differently — hence agreement on >= 99.99% of rays, not all.
    hit_diff = hk != hx
    tri_diff = both & (k[8] != x[8])
    # t comes from differences of coordinates of magnitude ~500 (the box
    # and the grid span ~550 units), so its rounding error is absolute,
    # ~1e-4, whatever t is: rtol 1e-5 plus that atol
    t_diff = both & ~np.isclose(k[0], x[0], rtol=1e-5, atol=1e-4)
    bad = hit_diff | tri_diff | t_diff
    frac = 1.0 - bad.mean()
    # shading attributes of the same triangle: float32 interpolation of
    # unit normals / texcoords, last-ulp differences in (u, v) only
    attr_err = max(float(np.abs(k[i][same_tri] - x[i][same_tri]).max(initial=0))
                   for i in range(1, 6))
    # |cos| between ray and surface of the rays that disagree: grazing
    # rays are where float32 rounding moves t the most
    tri = np.maximum(np.where(hk, k[8], x[8]), 0).astype(np.int64)
    dirs = np.stack([np.asarray(r) for r in rays[3:]], axis=1)
    cos = np.abs((dirs * np.asarray(scene.gn)[tri]).sum(1))
    print(f"phase 4 {name} closest: {both.sum()} of {N_RAYS} rays hit both ways, "
          f"agreement {frac:.6f} (hit set differs on {hit_diff.sum()}, triangle "
          f"on {tri_diff.sum()}, t on {t_diff.sum()}; |cos| of those rays: "
          f"max {cos[bad].max(initial=0):.3g}, median "
          f"{np.median(cos[bad]) if bad.any() else 0:.3g}), max attribute diff "
          f"{attr_err:.3g}; kernel {times['cuda'] * 1e3:.3f} ms, "
          f"xla {times['xla'] * 1e3:.3f} ms")
    for j in np.nonzero(bad)[0][:4]:
        print(f"    ray {j}: kernel t={k[0][j]!r} tri={k[8][j]} mtl={k[6][j]}; "
              f"xla t={x[0][j]!r} tri={x[8][j]} mtl={x[6][j]}; |cos|={cos[j]:.3g}")
    assert frac >= 0.9999, f"{name}: closest-hit agreement {frac}"
    assert attr_err <= 1e-4, f"{name}: attribute difference {attr_err}"
    report[f"{name}_closest_ms"] = {t: times[t] * 1e3 for t in times}

    srays, tb, tg = _shadow_rays(rng, scene, N_RAYS)
    vis, stimes = {}, {}
    for trace in ("cuda", "xla"):
        cfg = RenderConfig(trace=trace)
        fn = lambda *r, cfg=cfg: fused_trace_planes(
            scene, *r, cfg, t_bound=tb, target_mtl=tg, query="occlusion")
        (bt, seen), stimes[trace] = _timed(fn, *srays)
        vis[trace] = (np.asarray(seen) > 0.5) & (np.asarray(bt) >= 0)
    vfrac = (vis["cuda"] == vis["xla"]).mean()
    print(f"phase 4 {name} occlusion: visible {vis['cuda'].mean():.4f}, "
          f"agreement {vfrac:.6f}; kernel {stimes['cuda'] * 1e3:.3f} ms, "
          f"xla {stimes['xla'] * 1e3:.3f} ms")
    # same reasons as above: only grazing / tie-band rays may differ
    assert vfrac >= 0.9999, f"{name}: occlusion agreement {vfrac}"
    report[f"{name}_occlusion_ms"] = {t: stimes[t] * 1e3 for t in stimes}


def phase_kernel(img_kernel, kd_kernel):
    """Phase 4: the CUDA kernel against the plain path, on the card."""
    import jax
    import numpy as np

    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.integrator.fused import render_fused_jit
    from tinyraytracing_tpu.ops.trace import use_kernel

    assert use_kernel(RenderConfig()), "trace='auto' does not pick the kernel"
    rng = np.random.default_rng(0)
    report = {}
    _compare_trace("cornell", _cornell()[0], rng, report)
    _compare_trace("grid100K", _grid()[0], rng, report)

    # end to end: phase 1's render both ways ("auto" is the kernel here,
    # and the very configuration phase 1 compiled)
    scene, cam = _cornell()
    imgs, times = {}, {}
    for trace in ("auto", "xla"):
        cfg = RenderConfig(spp=16, trace=trace)
        fn = lambda cfg=cfg: render_fused_jit(
            scene, cam, jax.random.PRNGKey(0), cfg, 16)
        img, times[trace] = _timed(fn, reps=2)
        imgs[trace] = np.asarray(img)
    assert np.array_equal(imgs["auto"], img_kernel), "phase 1 image not reproduced"
    rel = abs(imgs["auto"].mean() - imgs["xla"].mean()) / imgs["xla"].mean()
    print(f"phase 4 cornell render 512x512 16spp: means {imgs['auto'].mean():.6f} "
          f"(kernel) vs {imgs['xla'].mean():.6f} (xla), rel diff {rel:.2e}; "
          f"kernel {times['auto']:.4f} s, xla {times['xla']:.4f} s")
    # a flipped hit changes one path's radiance, which moves a pixel by
    # O(value / spp); over 4M paths the image mean stays within 0.5%
    assert np.isfinite(imgs["xla"]).all() and rel < 5e-3, rel
    report["cornell_render_s"] = times

    # gradients: phase 3 both ways
    scene, cam, target, params = _grad_setup()
    gts = {}
    for trace in ("auto", "xla"):
        vg = _value_and_grad(RenderConfig(max_depth=8, trace=trace))
        (_, g), gts[trace] = _timed(vg, params, scene, cam, target, reps=2)
        if trace == "xla":
            kd_xla = np.asarray(g.kd)
        else:
            assert np.allclose(np.asarray(g.kd), kd_kernel, rtol=1e-5,
                               atol=1e-9), "phase 3 gradient not reproduced"
    rel_l1 = np.abs(kd_kernel - kd_xla).sum() / np.abs(kd_xla).sum()
    print(f"phase 4 cornell kd gradient: relative L1 difference {rel_l1:.2e}; "
          f"value_and_grad kernel {gts['auto']:.4f} s, xla {gts['xla']:.4f} s")
    # as for the image: flipped hits move individual path contributions
    assert rel_l1 < 1e-2, rel_l1
    report["cornell_value_and_grad_s"] = gts
    return report


def run_multi():
    """--multi: the sharded renderers and gradients on a 4-GPU mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tinyraytracing_tpu.config import RenderConfig
    from tinyraytracing_tpu.diff.fast import render_loss_fast
    from tinyraytracing_tpu.integrator.fused import render_fused_jit
    from tinyraytracing_tpu.integrator.fused_queue import render_fused_queue_jit
    from tinyraytracing_tpu.parallel.mesh import (
        make_mesh,
        render_fused_sharded,
        render_loss_fast_sharded,
        render_queue_sharded,
        render_queue_sharded_chunked,
    )

    devices = jax.devices()
    assert len(devices) >= 4, f"--multi needs 4 GPUs, found {len(devices)}"
    mesh = make_mesh(devices=devices[:4])
    key = jax.random.PRNGKey(0)

    scene, cam = _cornell()
    cfg = RenderConfig()
    # the same lane count per device as the one-GPU render, so both compile
    # the same loop body: pixel values are then bitwise partition-free
    lanes = -(-cam.width * cam.height // (128 * 4)) * 128
    one = np.asarray(render_fused_jit(scene, cam, key, cfg, 16, lanes=lanes))
    t0 = time.perf_counter()
    img, _ = render_fused_sharded(scene, cam, key, cfg, 16, mesh, lanes=lanes)
    img = np.asarray(img)
    dt = time.perf_counter() - t0
    print(f"multi fused: cornell 512x512 16spp on 4 GPUs {dt:.2f}s incl. "
          f"compile, bitwise equal to one GPU: {np.array_equal(img, one)}")
    assert np.array_equal(img, one), "fused sharded image != one GPU's"

    gscene, gcam = _grid()
    one = np.asarray(render_fused_queue_jit(gscene, gcam, key, cfg, 4))
    img, _ = render_queue_sharded(gscene, gcam, key, cfg, 4, mesh)
    chunked, _ = render_queue_sharded_chunked(gscene, gcam, key, cfg, 4, mesh)
    # each pixel sums the same path radiances in another order (scatter-add
    # order depends on the lane schedule): float32 reorder error only
    for tag, x in (("one-shot", img), ("chunked", chunked)):
        err = float(np.abs(np.asarray(x) - one).max())
        print(f"multi queue {tag}: grid100K 1280x720 4spp, max |diff| to one "
              f"GPU {err:.3g}")
        np.testing.assert_allclose(np.asarray(x), one, rtol=2e-5, atol=2e-5)

    from tinyraytracing_tpu.diff.inverse import SceneParams

    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
    params = SceneParams.init_from(scene, cam, "kd", "vertex_offset", "eye")
    gcfg = RenderConfig(max_depth=8)
    l1, g1 = jax.jit(jax.value_and_grad(
        lambda p, s, c, t: render_loss_fast(p, s, c, key, t, gcfg, 4)
    ))(params, scene, cam, target)
    l4, g4 = jax.jit(jax.value_and_grad(
        lambda p, s, c, t: render_loss_fast_sharded(p, s, c, key, t, gcfg, 4,
                                                    mesh)
    ))(params, scene, cam, target)
    print(f"multi grad: loss {float(l1):.8g} (one GPU) vs {float(l4):.8g} (4 GPUs)")
    # same pixels, partial sums reduced in another order
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g4)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=2e-4,
                                   atol=1e-6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU sharded checks")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "tinyraytracing_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX runs on {devices[0].platform!r}", file=sys.stderr)
        return 3
    from tinyraytracing_tpu.utils.compile_cache import enable_compile_cache

    print("compile cache:", enable_compile_cache())
    print("jax.devices():", devices)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)

    t_start = time.perf_counter()
    count = 1
    if args.multi:
        run_multi()
        count = 4
    else:
        with tempfile.TemporaryDirectory() as tmp:
            img = phase_cli(tmp)
            phase_queue(tmp)
        kd = phase_grad()
        report = phase_kernel(img, kd)
        print("phase 4 times:", json.dumps(report))
    print(f"total {time.perf_counter() - t_start:.1f}s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
