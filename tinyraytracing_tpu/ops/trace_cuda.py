"""Build, register and call the CUDA trace kernel (ops/trace_kernel.cu).

The library is compiled with ``nvcc`` on first use into the package's
git-ignored ``_cache/`` directory, under a name keyed on the source's
content, then registered as the XLA FFI target ``tinypt_trace`` for the
CUDA platform. A failed build raises: there is no fallback to another
trace on a GPU. The toolkit is found through ``CUDA_HOME`` (default
``/usr/local/cuda``) or ``nvcc`` on ``PATH``.

``pack_inputs`` lays the scene out the way the kernel reads it and is plain
JAX, so its shapes and padding are testable without a GPU; ``trace_call`` is
the one function that reaches the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "trace_kernel.cu")
_CACHE = os.path.join(_DIR, "_cache")
TARGET = "tinypt_trace"
# must match kStackSize in trace_kernel.cu
STACK_SIZE = 64
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA trace kernel cannot be built"
        )
    return found


def library_path() -> str:
    """Path of the compiled library for the current source, building it
    first if needed."""
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(
        src + " ".join(NVCC_FLAGS).encode() + jax.__version__.encode()
    ).hexdigest()[:16]
    so = os.path.join(_CACHE, f"libtinypt_trace_{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_CACHE, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_CACHE)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"building the CUDA trace kernel failed: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def register() -> None:
    """Build (if needed) and register the FFI target once per process."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(library_path())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.TinyptTrace), platform="CUDA"
        )
        _registered = True


def pack_inputs(scene, ox, oy, oz, dx, dy, dz, t_bound, target_mtl):
    """Kernel operands: rays (8, R) f32; nodes (N, 8) f32 = [min xyz, max
    xyz, first, count] with the two ints bit-cast (first = leaf start or
    right child); tris (T, 12) f32 = [v0, e1, e2, gn]; info (T,) i32 =
    material * 2 + emissive. Inputs are detached: the kernel's outputs are
    hit records, and gradients come from the path replay (diff/fast.py)."""
    sg = jax.lax.stop_gradient
    bvh = scene.bvh
    if bvh.n_levels > STACK_SIZE:
        raise ValueError(
            f"BVH depth {bvh.n_levels} exceeds the kernel stack ({STACK_SIZE})"
        )
    rays = sg(jnp.stack([ox, oy, oz, dx, dy, dz, t_bound, target_mtl]))
    n = bvh.count.shape[0]
    right = bvh.skip[jnp.minimum(jnp.arange(n) + 1, n - 1)]
    first = jnp.where(bvh.count > 0, bvh.start, right)
    as_f32 = lambda x: jax.lax.bitcast_convert_type(
        x.astype(jnp.int32), jnp.float32
    )[:, None]
    nodes = sg(jnp.concatenate(
        [bvh.nmin, bvh.nmax, as_f32(first), as_f32(bvh.count)], axis=1
    ))
    tris = sg(jnp.concatenate(
        [scene.v0, scene.v1 - scene.v0, scene.v2 - scene.v0, scene.gn], axis=1
    ))
    info = scene.tri_mtl.astype(jnp.int32) * 2 + scene.tri_emissive.astype(
        jnp.int32
    )
    return rays, nodes, tris, info


def trace_call(rays, nodes, tris, info, *, t_min, graze, tie_eps):
    """The FFI call: returns (t, tri, u, v), each (R,)."""
    register()
    R = rays.shape[1]
    f32 = jax.ShapeDtypeStruct((R,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((R,), jnp.int32)
    return jax.ffi.ffi_call(TARGET, (f32, i32, f32, f32))(
        rays, nodes, tris, info,
        t_min=np.float32(t_min), graze=np.float32(graze),
        tie_eps=np.float32(tie_eps),
    )
