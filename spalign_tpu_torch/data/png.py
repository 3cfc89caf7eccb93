"""PNG decode and encode without cv2 or PIL.

The JAX package reads images with ``cv2.imdecode`` and writes masks with
``cv2.imwrite``; the card's machine has neither cv2 nor PIL.  Decoding
parses the chunks here, inflates the image data with the standard
library's ``zlib`` (which releases the GIL) and un-filters the rows in
the host library (``native.png_unfilter``).  What comes out is what
cv2 gives for 8-bit files:

- ``color=True`` (``IMREAD_COLOR``, returned as RGB): grey replicated to
  three channels, alpha dropped, palettes expanded;
- ``color=False`` (``IMREAD_GRAYSCALE``): grey as it is, alpha dropped,
  colour converted with libpng's fixed-point weights (red 9797, green
  19234, blue 9737, over 2**15, truncated), which cv2 asks libpng for.

Interlaced (Adam7), 16-bit and sub-byte (1, 2 and 4-bit) files raise
``ValueError`` naming the form.  Encoding writes 8-bit grey or RGB with
filter type 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from spalign_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha",
                6: "RGBA"}
# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587) weights over 2**15
_GREY_R, _GREY_G = 9797, 19234
_GREY_B = 32768 - _GREY_R - _GREY_G


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or corrupt")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before its IEND chunk")


def _grey_of(rgb: np.ndarray) -> np.ndarray:
    """libpng's RGB -> grey (what cv2.IMREAD_GRAYSCALE gets)."""
    c = rgb.astype(np.int32)
    grey = (_GREY_R * c[..., 0] + _GREY_G * c[..., 1]
            + _GREY_B * c[..., 2]) >> 15
    same = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 0] == rgb[..., 2])
    return np.where(same, rgb[..., 0], grey).astype(np.uint8)


def decode_png(data: bytes, color: bool = True) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (``color``) or (H, W) uint8 grey."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(bytes(data)):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not valid")
    form = _COLOR_NAMES[ctype]
    if interlace:
        raise ValueError(f"interlaced (Adam7) {form} PNG is not supported")
    if depth != 8:
        raise ValueError(f"{depth}-bit {form} PNG is not supported (8-bit "
                         f"only)")
    ch = _CHANNELS[ctype]
    px = native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * ch,
                             ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        # libpng keeps 256 entries; indices past the palette read black
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        px = full[px[..., 0]]
    elif ctype in (0, 4):
        grey = px[..., 0]
        return np.repeat(grey[..., None], 3, axis=-1) if color else grey
    rgb = np.ascontiguousarray(px[..., :3])
    return rgb if color else _grey_of(rgb)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> PNG bytes (filter type 0,
    zlib's default compression)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[-1] == 3:
        ctype, ch = 2, 3
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + w * ch), np.uint8)
    raw[:, 1:] = img.reshape(h, w * ch)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(img))
