"""Component-plane vector math.

The natural (R, 3) vector layout puts xyz in the minor dimension, which
wastes most of every vector register and memory transaction on
accelerators that tile the last dimension. The hot path instead carries
each vector as THREE full planes of R rays, and these helpers operate on
(x, y, z) component triples.

Everything is shape-polymorphic: components may be any equal shape.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

V3 = tuple  # (x, y, z) component triple


def splat(v, shape):
    """Broadcast a (3,) constant vector to component planes."""
    return (
        jnp.full(shape, v[0], jnp.float32),
        jnp.full(shape, v[1], jnp.float32),
        jnp.full(shape, v[2], jnp.float32),
    )


def from_rows(a):
    """(N, 3) array -> component triple of (N,) arrays."""
    return a[:, 0], a[:, 1], a[:, 2]


def to_rows(c):
    """component triple -> (N, 3)."""
    return jnp.stack(c, axis=-1)


def add(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def mul(a, b):
    return a[0] * b[0], a[1] * b[1], a[2] * b[2]


def scale(a, s):
    return a[0] * s, a[1] * s, a[2] * s


def neg(a):
    return -a[0], -a[1], -a[2]


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length2(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(jnp.maximum(length2(a), 0.0))


def normalize(a):
    inv = lax.rsqrt(jnp.maximum(length2(a), 1e-30))
    return scale(a, inv)


def where(m, a, b):
    return (
        jnp.where(m, a[0], b[0]),
        jnp.where(m, a[1], b[1]),
        jnp.where(m, a[2], b[2]),
    )


def reflect(d, n):
    """glm::reflect: d - 2 dot(d,n) n."""
    k = 2.0 * dot(d, n)
    return d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2]


def refract(d, n, eta):
    """glm::refract; returns (dir, tir_mask)."""
    cosi = dot(n, d)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    s = eta * cosi + jnp.sqrt(jnp.maximum(k, 0.0))
    out = (eta * d[0] - s * n[0], eta * d[1] - s * n[1], eta * d[2] - s * n[2])
    return out, tir


def gather(table, idx):
    """(T, 3) table -> component triple gathered at idx (any shape)."""
    return table[idx, 0], table[idx, 1], table[idx, 2]
