"""Minimal PNG writer, numpy and the standard library only (a copy of
write_png in tracer_tpu/utils/image.py), and the viewer's ARGB unpacking,
recorded as a span (utils/profiling)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tracer_tpu_torch.utils import profiling


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """Write an (h, w, 3) float [0,1] or uint8 image as RGB8 PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", header)
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def argb_to_rgb(argb) -> np.ndarray:
    """(h, w) uint32 ARGB framebuffer (what render() returns) -> (h, w, 3)
    uint8. Span image.argb_to_rgb (utils/profiling)."""
    with profiling.span("image.argb_to_rgb"):
        a = np.asarray(argb, dtype=np.uint32)
        return np.stack([(a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF],
                        axis=-1).astype(np.uint8)
