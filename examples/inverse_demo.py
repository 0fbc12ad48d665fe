"""Inverse rendering on the FAST path: recover the cornell box's wall
albedos from a target image by gradient descent through the trace
(diff/fast.py custom-VJP path replay).

Run (any backend; a GPU for speed):
    python examples/inverse_demo.py [steps] [resolution]
"""
import sys

import jax
import jax.numpy as jnp
import optax

from tinyraytracing_tpu.config import RenderConfig
from tinyraytracing_tpu.diff.fast import render_diff, render_loss_fast
from tinyraytracing_tpu.diff.inverse import SceneParams
from tinyraytracing_tpu.models.procedural import cornell_box
from tinyraytracing_tpu.ops.bvh import attach_bvh

steps = int(sys.argv[1]) if len(sys.argv) > 1 else 40
res = int(sys.argv[2]) if len(sys.argv) > 2 else 64

cfg = RenderConfig(intersector="bvh", max_depth=4)
scene, cam = cornell_box(width=res, height=res)
scene = attach_bvh(scene, cfg)
key = jax.random.PRNGKey(0)

target = jax.lax.stop_gradient(render_diff(scene, cam, key, cfg, spp=4))

params = SceneParams(kd=jnp.full_like(scene.kd, 0.5))   # wrong albedos
opt = optax.adam(0.05)
state = opt.init(params)


@jax.jit
def step(params, state, key):
    loss, g = jax.value_and_grad(render_loss_fast)(
        params, scene, cam, key, target, cfg, 4
    )
    updates, state = opt.update(g, state, params)
    return optax.apply_updates(params, updates), state, loss


# emitters never use kd (emissive hits return radiance directly,
# reference pathTracing.cpp:9-12), so their kd is unobservable — report
# recovery error over the observable materials only
obs = ~scene.mtl_emissive

for i in range(steps):
    params, state, loss = step(params, state, jax.random.fold_in(key, i))
    if i % 10 == 0 or i == steps - 1:
        err = float(jnp.abs(params.kd - scene.kd)[obs].max())
        print(f"step {i:3d}: loss {float(loss):.6f}  max|kd err| {err:.4f}")

print("true kd[:3]:", scene.kd[:3])
print("recovered  :", params.kd[:3])
