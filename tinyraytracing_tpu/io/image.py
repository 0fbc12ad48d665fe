"""Tonemap + PNG output.

Identical tonemap to the reference so golden images compare directly:
``uint8(clamp(pow(linear, 1/2.2) * 255, 0, 255))`` with C-style truncating
cast (reference: RayTracingOnCPU/main.cpp:34-36). The PNG is written with
zlib + struct alone, as the reference's vendored svpng does (8-bit RGB,
one IDAT chunk, filter 0 on every row). Output naming follows the
reference's ``<basedir>/image<SPP>.png`` convention (main.cpp:26).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap_srgb(linear: np.ndarray) -> np.ndarray:
    """(H, W, 3) linear float -> (H, W, 3) uint8, reference-identical."""
    x = np.asarray(linear, dtype=np.float64)
    x = np.clip(np.power(np.maximum(x, 0.0), 1.0 / 2.2) * 255.0, 0.0, 255.0)
    return x.astype(np.uint8)  # truncation, like the reference's C cast


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG file bytes."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()                                   # filter byte 0 per row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, linear: np.ndarray) -> None:
    """Tonemap a linear (H, W, 3) image and write it as an RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(tonemap_srgb(linear)))


def read_png(path: str) -> np.ndarray:
    """Read a PNG as (H, W, 3) uint8 (golden-image comparisons in the
    tests; needs Pillow)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
