"""The yuv420 image wire of the label path.

BT.601 full-range YCbCr with 2x2-subsampled chroma: 1.5 B/px, half the
bytes of rgb8 (counterpart of ``spalign_tpu/pipeline/wire.py``).  The
host packs with cv2's own integer arithmetic, so the packed bytes equal
``cv2.cvtColor(..., COLOR_RGB2YCrCb)`` followed by an ``INTER_AREA`` 2x
chroma downscale: the label paths call the host library's
``native.pack_yuv420`` (C++, threaded over images); ``pack_yuv420``
here is its plain numpy version.  The device decodes in torch,
bit-exact with the JAX decode.
"""

from __future__ import annotations

import numpy as np
import torch

# cv2's fixed-point RGB -> YCrCb coefficients (14 fractional bits)
_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
_Y_R, _Y_G, _Y_B = 4899, 9617, 1868
_CR, _CB = 11682, 9241


def yuv420_bytes_per_image(hw) -> int:
    h, w = hw
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs even dimensions, got {hw}")
    return h * w + (h // 2) * (w // 2) * 2


def pack_yuv420(images_uint8: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 RGB -> (B, 1.5*H*W) uint8 YUV420 planes.

    Per image: [Y (H*W) | Cr (H/2*W/2) | Cb (H/2*W/2)]."""
    b, h, w, _ = images_uint8.shape
    n_bytes = yuv420_bytes_per_image((h, w))
    rgb = images_uint8.astype(np.int32)
    r, g, bl = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (_Y_R * r + _Y_G * g + _Y_B * bl + _HALF) >> _SHIFT
    bias = (128 << _SHIFT) + _HALF
    cr = np.clip(((r - y) * _CR + bias) >> _SHIFT, 0, 255)
    cb = np.clip(((bl - y) * _CB + bias) >> _SHIFT, 0, 255)

    def area2(c):  # INTER_AREA 2x: rounded mean of each 2x2 block
        s = c.reshape(b, h // 2, 2, w // 2, 2).sum(axis=(2, 4))
        return (s + 2) >> 2

    out = np.empty((b, n_bytes), np.uint8)
    n, q = h * w, (h // 2) * (w // 2)
    out[:, :n] = y.reshape(b, n)
    out[:, n:n + q] = area2(cr).reshape(b, q)
    out[:, n + q:] = area2(cb).reshape(b, q)
    return out


def decode_yuv420(packed: torch.Tensor, hw) -> torch.Tensor:
    """(B, 1.5*H*W) uint8 -> (B, H, W, 3) uint8 RGB on the tensor's device.

    Inverts cv2's full-range BT.601 (delta 128): R = Y + 1.403 Cr',
    G = Y - 0.714 Cr' - 0.344 Cb', B = Y + 1.773 Cb'; chroma upsampled
    nearest-neighbour.  Same float32 operations, in the same order, as
    the JAX decode."""
    h, w = hw
    n = h * w
    q = n // 4

    def chroma(plane):
        c = plane.reshape(-1, h // 2, 1, w // 2, 1).to(torch.float32)
        c = c.expand(-1, h // 2, 2, w // 2, 2)
        return c.reshape(-1, h, w) - 128.0

    y = packed[:, :n].reshape(-1, h, w).to(torch.float32)
    cr = chroma(packed[:, n:n + q])
    cb = chroma(packed[:, n + q:])
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    bch = y + 1.773 * cb
    rgb = torch.stack([r, g, bch], dim=-1)
    return torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)
