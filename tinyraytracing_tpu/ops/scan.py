"""Matmul-based prefix sum over a lane plane.

The queue renderer needs exactly one inclusive prefix sum per iteration
(ranking dead lanes against the global path queue), so this is on the
per-iteration critical path. It was written for a machine where
``jnp.cumsum`` was slow; whether it beats ``jnp.cumsum`` on the GPU is not
measured yet.

This implementation blocks the plane into (rows, 128) and computes the
scan with two small triangular matmuls — prefix-within-row and
prefix-over-row-totals:

    y = x @ U128  (U = upper-triangular ones: inclusive scan per row)
    row offsets = exclusive scan of row totals (recursively, tiny)

All counts stay below 2^24 so float32 accumulation is exact for 0/1
inputs (and any integer input with sum < 2^24).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _triu_ones(n):
    # U[i, j] = 1 for i <= j  ->  (x @ U)[j] = sum_{i<=j} x[i]
    i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return (i <= j).astype(jnp.float32)


def prefix_sum_lanes(x):
    """Inclusive prefix sum of a 1-D integer/float plane, exact for
    integer sums < 2^24. Returns int32 if input is integral, else f32.

    Falls back to jnp.cumsum below one (8, 128) tile.
    """
    n = x.shape[0]
    integral = jnp.issubdtype(x.dtype, jnp.integer) or x.dtype == jnp.bool_
    if n < 1024:
        out = jnp.cumsum(x.astype(jnp.int32 if integral else x.dtype))
        return out
    pad = (-n) % 128
    xf = jnp.pad(x.astype(jnp.float32), (0, pad))
    rows = xf.reshape(-1, 128)
    u = _triu_ones(128)
    within = jax.lax.dot_general(
        rows, u, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    totals = within[:, -1]
    if totals.shape[0] > 1024:
        run = prefix_sum_lanes(totals).astype(jnp.float32)
    else:
        run = jnp.cumsum(totals)
    offsets = run - totals                       # exclusive over rows
    out = (within + offsets[:, None]).reshape(-1)[:n]
    return out.astype(jnp.int32) if integral else out
