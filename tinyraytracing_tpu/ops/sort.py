"""Broadcast-key plane permutation: stable-sort many same-shape planes by
one key with a single 2-OPERAND lax.sort.

The obvious forms have costs this one avoids:

- argsort + per-plane permutation GATHERS: one random-index gather per
  plane;
- one VARIADIC sort with every plane as an operand: XLA's comparator
  code generation grows with the operand count, and a 21-operand sort
  compiled for minutes.

This form stacks the payload planes into one (C, ...) array (non-f32
planes bitcast to f32 — sort PAYLOADS are never compared, only moved, so
the bit pattern is opaque; bools are value-cast), broadcasts the key
over the stacked axis, and runs ONE 2-operand stable sort along the data
axis: every row sees identical keys, and stability then gives every row
the SAME permutation — exactly the stable-argsort order. Its time on the
GPU is not measured yet.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _to_f32(x):
    if x.dtype == jnp.float32:
        return x
    if x.dtype == jnp.bool_:
        return x.astype(jnp.float32)            # exact 0.0 / 1.0
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _from_f32(x, dtype):
    if dtype == jnp.float32:
        return x
    if dtype == jnp.bool_:
        return x > 0.5
    return jax.lax.bitcast_convert_type(x, dtype)


def sort_planes_by(key, planes, axis: int = -1):
    """Stable-sort each of ``planes`` (same shape as ``key``) along
    ``axis`` of ``key``, all by the SAME key order; returns the sorted
    planes (original dtypes). Ties keep their original order, so the
    permutation equals ``jnp.argsort(key, stable=True)`` applied along
    ``axis`` — per slice, for multi-axis keys."""
    planes = list(planes)
    axis = axis % key.ndim
    packed = jnp.stack([_to_f32(p) for p in planes], axis=0)
    kb = jnp.broadcast_to(key[None], packed.shape)
    _, sp = jax.lax.sort((kb, packed), dimension=axis + 1, num_keys=1,
                         is_stable=True)
    return [_from_f32(sp[c], p.dtype) for c, p in enumerate(planes)]
