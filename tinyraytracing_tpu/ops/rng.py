"""Planar counter-based RNG: Threefry-2x32 on component planes.

The fused renderers draw 4L+5 uniforms per (path, bounce). Drawing them
with ``jax.vmap(jax.random.fold_in)`` + per-lane ``uniform((4L+5,))``
compiles into a poorly-fused per-lane program. This module implements the
same Threefry-2x32 block cipher directly on (R,) uint32 planes: each draw
is ~70 fused elementwise ops over the whole lane array, with the same
counter-based structure — every value is a pure
function of (seed, path_id, bounce, draw index), so images remain
BITWISE independent of how paths are packed into lanes, epochs, or
device shards (the property tests/test_trace.py pins).

Threefry-2x32-20 (Salmon et al., SC'11 — public algorithm, the standard
20-round schedule, same as jax's own PRNG) over planes; this is an
independent implementation, not a copy of jax's (jax applies it via
lax.bitcast tricks; here it is plain jnp uint32 arithmetic so XLA fuses
it into the surrounding bounce math). Bit-for-bit equality with jax's
threefry2x32 is pinned in tests/test_utils.py.

Stream layout:
- path key  = TF(master_key, (path_id, PATH_TAG))
- draw pair = TF(path_key, (bounce, draw_pair_index))
  giving 2 uniforms per block; uniform = (bits >> 8) * 2^-24 in [0, 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = jnp.uint32(0x1BD11BDA)
PATH_TAG = jnp.uint32(0x9E3779B9)


def _rotl(x, r):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 (the standard 20-round schedule, as used by jax's
    PRNG — 5 groups of 4 rounds with a key injection after each group).
    All args uint32 arrays (broadcastable); returns a pair of uint32
    arrays. Cross-validated bit-for-bit against jax's threefry2x32 in
    tests/test_utils.py."""
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(c0, jnp.uint32) + k0
    x1 = jnp.asarray(c1, jnp.uint32) + k1
    ks2 = k0 ^ k1 ^ _PARITY
    sched = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    rounds = (_ROT[0], _ROT[1], _ROT[0], _ROT[1], _ROT[0])
    for block in range(5):
        for r in rounds[block]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        a, b = sched[block]
        x0 = x0 + a
        x1 = x1 + b + jnp.uint32(block + 1)
    return x0, x1


def bits_to_uniform(bits):
    """uint32 bits -> float32 uniform in [0, 1) with 24-bit resolution."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def master_key_data(key):
    """(2,) uint32 key data from either a typed jax PRNG key or a legacy
    (2,) uint32 key array."""
    if hasattr(key, "dtype") and jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        return jax.random.key_data(key).reshape(2)
    return jnp.asarray(key, jnp.uint32).reshape(2)


def path_keys(key_data, path_id):
    """Per-path key planes from the master key.

    key_data: (2,) uint32 (jax.random.key_data of the render key).
    path_id: (R,) int32/uint32 global path ids.
    Returns (k0, k1) uint32 planes — the per-path RNG key.
    """
    pid = jnp.asarray(path_id).astype(jnp.uint32)
    return threefry2x32(key_data[0], key_data[1], pid, PATH_TAG)


def bounce_uniforms(k0, k1, bounce, n):
    """``n`` uniforms per lane for this (path, bounce).

    k0, k1: (R,) uint32 path-key planes; bounce: (R,) int32.
    Returns a list of n (R,) float32 planes in [0, 1). Pure function of
    (path key, bounce, draw index) — scheduling-independent.
    """
    b = jnp.asarray(bounce).astype(jnp.uint32)
    out = []
    for blk in range((n + 1) // 2):
        r0, r1 = threefry2x32(k0, k1, b, jnp.uint32(blk))
        out.append(bits_to_uniform(r0))
        out.append(bits_to_uniform(r1))
    return out[:n]
