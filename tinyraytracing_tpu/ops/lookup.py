"""Gather-free small-table lookups.

For the tiny tables a renderer keeps consulting per bounce — materials
(M ~ 4-36 rows), per-light triangle lists (K ~ 2-8 rows) — a chain of
``where(idx == k, table[k], ...)`` selects replaces a per-lane gather with
pure elementwise code that XLA fuses into the surrounding bounce math.
(Written for a machine where gathers were expensive; on the GPU the
comparison with a plain gather is not measured yet.)

Cost is O(M * C) vector ops per call, so these helpers fall back to a
real gather past ``CHAIN_LIMIT`` rows where the chain would stop winning.
"""

from __future__ import annotations

import jax.numpy as jnp

# beyond this many table rows a select chain stops beating a gather
CHAIN_LIMIT = 64


def chain_lookup(table, idx):
    """Look up ``table[idx]`` without a gather when the table is small.

    table: (M,) or (M, C) array (typically a jit-closure constant).
    idx:   integer array of any shape.
    Returns an array shaped idx.shape (+ (C,)) like ``table[idx]``.
    """
    M = table.shape[0]
    if M > CHAIN_LIMIT:
        return table[idx]
    if table.ndim == 1:
        out = jnp.full(idx.shape, table[M - 1], dtype=table.dtype)
        for k in range(M - 2, -1, -1):
            out = jnp.where(idx == k, table[k], out)
        return out
    cols = [chain_lookup(table[:, c], idx) for c in range(table.shape[1])]
    return jnp.stack(cols, axis=-1)


def chain_lookup_planes(table, idx):
    """Like chain_lookup for a (M, C) table, but returns a TUPLE of C
    component planes shaped like idx (the ops/vec.py planar layout)."""
    return tuple(chain_lookup(table[:, c], idx) for c in range(table.shape[1]))
