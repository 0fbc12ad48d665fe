"""Differentiable rendering.

The reference is not differentiable at all; this package provides the
north-star capability (BASELINE.json): pixel gradients w.r.t. material
albedo, light radiance, vertex positions, and camera pose via path-replay
style backward passes (sampling decisions detached, contribution terms
differentiated — config.detach_sampling), validated against finite
differences in tests/test_diff.py.

Three layers:

- diff/inverse.py — SceneParams / apply_params / render_loss over the
  fixed-depth scan renderer (the round-1 path; any intersector).
- diff/fast.py — the FAST path: jax.custom_vjp around the trace
  (ops/trace.py; backward = closed-form Möller–Trumbore path replay of the
  recorded hit triangles) + a planar fixed-depth renderer; apply_params
  REFITS the BVH under vertex offsets (diff/refit.py) instead of dropping
  it.
- diff/edge.py — boundary-term prototype (edge-sampled visibility
  gradients) for silhouette-dominated losses the interior-term replay
  cannot see (tests/test_diff_edge.py).
"""

from tinyraytracing_tpu.diff.inverse import (
    SceneParams,
    apply_params,
    render_loss,
    make_train_step,
)
from tinyraytracing_tpu.diff.fast import (
    fused_trace_diff,
    render_diff,
    render_loss_fast,
)

__all__ = [
    "SceneParams", "apply_params", "render_loss", "make_train_step",
    "fused_trace_diff", "render_diff", "render_loss_fast",
]
