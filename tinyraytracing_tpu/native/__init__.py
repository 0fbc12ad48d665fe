"""Native (C++) runtime components, loaded via ctypes.

The reference is a 100%-C++ program; per SURVEY.md §2 the host-side
heavy lifting of this framework is native too:

- ``bvh_builder.cc``  — O(N log N) SAH BVH builder (reference-equivalent
  splits), ~100x the numpy builder's speed at 1M triangles
- ``objparser.cc``    — fast OBJ triangle-soup parser with the reference's
  vt/vn layout heuristic

Compilation happens on demand with g++ (-O3, cached in ``_cache/`` keyed on
source mtime, written to a temporary file and renamed into place so that
concurrent processes never load a half-written library); no pybind11 —
plain ``extern "C"`` + ctypes. Everything has a pure-Python fallback;
import failures here must never break the package (ops/bvh.py and io code
catch ImportError).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_CACHE = os.path.join(_DIR, "_cache")


def _compile(name: str, srcs: list[str], extra: list[str] | None = None) -> str:
    os.makedirs(_CACHE, exist_ok=True)
    so = os.path.join(_CACHE, f"{name}.so")
    src_paths = [os.path.join(_DIR, s) for s in srcs]
    newest = max(os.path.getmtime(p) for p in src_paths)
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return so
    # -ffp-contract=off: no FMA contraction — SAH cost arithmetic must
    # round exactly like the float64 numpy builder so both produce
    # identical trees (tested in tests/test_io.py).
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_CACHE)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
        "-shared", "-fPIC", "-o", tmp, *src_paths, *(extra or []),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        os.unlink(tmp)
        detail = getattr(e, "stderr", b"")
        raise ImportError(f"native build failed: {cmd}: {detail!r}") from e
    os.replace(tmp, so)
    return so


def _load(name: str, srcs: list[str], extra=None) -> ctypes.CDLL:
    return ctypes.CDLL(_compile(name, srcs, extra))


# ---------------------------------------------------------------- BVH build
_bvh_lib = None


def build_bvh_native(tri_v: np.ndarray, leaf_size: int = 8, aabb_pad: float = 1e-3):
    """C++ SAH build. tri_v: (T, 3, 3). Returns (nodes dict, perm) like
    ops.bvh.build_bvh."""
    global _bvh_lib
    if _bvh_lib is None:
        lib = _load("tinypt_bvh", ["bvh_builder.cc"])
        lib.tinypt_build_bvh.restype = ctypes.c_int64
        lib.tinypt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        _bvh_lib = lib

    tri = np.ascontiguousarray(tri_v, dtype=np.float64).reshape(-1, 9)
    T = tri.shape[0]
    cap = max(2 * T, 1)
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    perm = np.empty(T, np.int64)

    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    n_nodes = _bvh_lib.tinypt_build_bvh(
        tri.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), T, leaf_size, aabb_pad,
        fptr(nmin), fptr(nmax), iptr(start), iptr(count), iptr(skip),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n_nodes <= 0:
        raise RuntimeError("native BVH build failed")
    nodes = dict(
        nmin=nmin[:n_nodes].copy(),
        nmax=nmax[:n_nodes].copy(),
        start=start[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
        skip=skip[:n_nodes].copy(),
    )
    return nodes, perm


# ---------------------------------------------------------------- OBJ parse
_obj_lib = None


def parse_obj_native(path: str):
    """C++ OBJ parse -> MeshArrays (same contract as io.objmesh.parse_obj)."""
    global _obj_lib
    if _obj_lib is None:
        lib = _load("tinypt_obj", ["objparser.cc"])
        lib.tinypt_obj_scan.restype = ctypes.c_int
        lib.tinypt_obj_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tinypt_obj_parse.restype = ctypes.c_int64
        lib.tinypt_obj_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int64,
        ]
        _obj_lib = lib

    from tinyraytracing_tpu.io.objmesh import MeshArrays

    bpath = os.fsencode(path)
    n_tris = ctypes.c_int64()
    names_bytes = ctypes.c_int64()
    if _obj_lib.tinypt_obj_scan(bpath, ctypes.byref(n_tris), ctypes.byref(names_bytes)) != 0:
        raise FileNotFoundError(path)
    T = n_tris.value
    v = np.empty((T, 3, 3), np.float64)
    vn = np.empty((T, 3, 3), np.float64)
    vt = np.empty((T, 3, 2), np.float64)
    mtl = np.empty(T, np.int32)
    names_buf = ctypes.create_string_buffer(int(names_bytes.value) + 1)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    got = _obj_lib.tinypt_obj_parse(
        bpath, dptr(v), dptr(vn), dptr(vt),
        mtl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        names_buf, names_bytes.value + 1,
    )
    if got != T:
        raise RuntimeError(f"obj parse mismatch: {got} != {T}")
    raw = names_buf.value.decode("utf-8", errors="replace")
    mtl_names = [n for n in raw.split("\n") if n != ""] or [""]
    if (mtl < 0).any():
        if "" not in mtl_names:
            mtl_names.append("")
        mtl = np.where(mtl < 0, mtl_names.index(""), mtl).astype(np.int32)

    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-30)
    return MeshArrays(
        v=v, vn=vn, vt=vt, normal=gn, center=v.mean(axis=1),
        mtl=mtl, mtl_names=mtl_names,
    )
