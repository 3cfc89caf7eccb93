"""A minimal PNG writer: 8-bit grey or RGB, filter type 0 on every row,
one IDAT chunk deflated by Python's ``zlib`` at level 1 (set-up time:
inflating, the reader's cost, hardly depends on the level).  The
benchmark writes its image files with it, so the files do not depend on
the program's codec.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> PNG bytes."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"want uint8 (H, W) or (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
