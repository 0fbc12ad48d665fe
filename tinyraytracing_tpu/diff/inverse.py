"""Inverse rendering: optimizable scene parameters + gradient-descent loop
(BASELINE.json config 4: recover albedo + vertex offsets on the Cornell box
via pixel-gradient descent)."""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.models.camera import Camera
from tinyraytracing_tpu.models.scene import Scene
from tinyraytracing_tpu.render import render


def _static():
    return dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneParams:
    """Differentiable leaves layered onto a Scene/Camera.

    Any field can be None (not optimized). vertex_offset is a per-triangle
    rigid offset added to all three vertices — silhouette gradients are
    interior-term only (see diff/__init__ docstring).
    """

    kd: jax.Array | None = None             # (M, 3) material albedo
    radiance: jax.Array | None = None       # (M, 3) emitter radiance
    vertex_offset: jax.Array | None = None  # (T, 3)
    eye: jax.Array | None = None            # (3,) camera position
    lookat: jax.Array | None = None         # (3,)

    @staticmethod
    def init_from(scene: Scene, cam: Camera, *fields: str) -> "SceneParams":
        src = dict(
            kd=scene.kd,
            radiance=scene.radiance,
            vertex_offset=jnp.zeros_like(scene.v0),
            eye=cam.eye,
            lookat=cam.lookat,
        )
        return SceneParams(**{f: src[f] for f in fields})


def woop_transform_jnp(v0, v1, v2):
    """Differentiable (f32, jnp) version of models.scene.woop_transform:
    per-triangle affine map to unit-barycentric space. Returns
    (A (T, 3, 3), b (T, 3), unit geometric normal (T, 3))."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = jnp.cross(e1, e2)
    det = jnp.sum(n * n, axis=-1)
    safe = det > 1e-24
    inv = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0), 0.0)
    a = jnp.stack([jnp.cross(e2, n), jnp.cross(n, e1), n], axis=1)
    a = a * inv[:, None, None]
    # HIGHEST: a float32 contraction may otherwise run in TF32 on a GPU
    b = -jnp.einsum("tij,tj->ti", a, v0, precision=jax.lax.Precision.HIGHEST)
    gn = n * jax.lax.rsqrt(jnp.maximum(det, 1e-30))[:, None]
    return a, b, gn


def apply_params(scene: Scene, cam: Camera, p: SceneParams):
    """Overlay the optimizable parameters onto scene + camera.

    ``vertex_offset`` moves all three vertices of each triangle rigidly and
    recomputes EVERY derived geometric quantity differentiably — the Woop
    rows the mxu intersector consumes and the geometric normal used by the
    grazing cull — so no backend silently traces the untranslated mesh. An
    attached BVH is REFIT in place (diff/refit.py, stop_gradient —
    gradients flow through the custom-VJP path replay, diff/fast.py),
    keeping the BVH trace live under vertex optimization; a BVH without
    refit metadata is dropped.
    """
    up_s = {}
    if p.kd is not None:
        up_s["kd"] = p.kd
    if p.radiance is not None:
        up_s["radiance"] = p.radiance
        # keep the light table's cached radiance consistent
        up_s["light_radiance"] = p.radiance[scene.light_mtl]
    if p.vertex_offset is not None:
        v0 = scene.v0 + p.vertex_offset
        v1 = scene.v1 + p.vertex_offset
        v2 = scene.v2 + p.vertex_offset
        woop_a, woop_b, gn = woop_transform_jnp(v0, v1, v2)
        # NEE light tables track moved emissive geometry via lt_tri.
        # Offsets are per-triangle rigid translations, so triangle areas
        # (lt_prefix / light_area) are invariant and stay valid.
        up_s.update(
            v0=v0, v1=v1, v2=v2,
            woop_a=woop_a, woop_b=woop_b, gn=gn,
            lt_v0=v0[scene.lt_tri], lt_v1=v1[scene.lt_tri],
            lt_v2=v2[scene.lt_tri],
        )
        if scene.bvh is not None and scene.bvh.tri_leaf is None:
            up_s["bvh"] = None
    if up_s:
        scene = dataclasses.replace(scene, **up_s)
        if p.vertex_offset is not None and scene.bvh is not None:
            scene = _refit_sg(scene)
    up_c = {}
    if p.eye is not None:
        up_c["eye"] = p.eye
    if p.lookat is not None:
        up_c["lookat"] = p.lookat
    if up_c:
        cam = dataclasses.replace(cam, **up_c)
    return scene, cam


def _refit_sg(scene: Scene) -> Scene:
    """Refit the BVH to the moved vertices, stop_gradient'ing ONLY the
    refit boxes — the scene's own arrays keep their gradient paths."""
    from tinyraytracing_tpu.diff.refit import refit_bvh

    refit = refit_bvh(scene)
    bvh_sg = jax.tree.map(jax.lax.stop_gradient, refit.bvh)
    return dataclasses.replace(scene, bvh=bvh_sg)


def render_loss(
    params: SceneParams,
    scene: Scene,
    cam: Camera,
    key,
    target,
    config: RenderConfig,
    spp: int,
):
    """Mean-squared pixel loss against a target image. Differentiable in
    ``params`` (path-replay interior-term gradients)."""
    s2, c2 = apply_params(scene, cam, params)
    img = render(s2, c2, key, config, spp)
    return jnp.mean((img - target) ** 2)


def make_train_step(scene, cam, target, config: RenderConfig, spp: int,
                    learning_rate: float = 0.05):
    """Returns (step_fn, init_state) for adam-based inverse rendering.

    step_fn(state, key) -> (state, loss); state = (params, opt_state).
    """
    import optax

    opt = optax.adam(learning_rate)

    @jax.jit
    def step(state, key):
        params, opt_state = state
        loss, grads = jax.value_and_grad(render_loss)(
            params, scene, cam, key, target, config, spp
        )
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    def init(params: SceneParams):
        return (params, opt.init(params))

    return step, init
