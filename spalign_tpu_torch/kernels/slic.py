"""SLIC superpixels of a batch of images on the device.

Counterpart of ``spalign_tpu/kernels/slic.py`` with the semantics of its
Pallas kernels: CIELAB features, centres seeded on a regular grid by
sampling LAB at the int-truncated grid positions, a 2*step Chebyshev
window on raw coordinates, compactness folded into the scaled
coordinates, the lowest id winning ties and an empty window falling back
to the unmasked argmax.  Labels are not guaranteed 4-connected.

Two engines compute the same labels (the counterpart of JAX's
``slic(use_fused=...)`` and ``slic(use_pallas=...)``):

  * ``"lloyd"``: the whole Lloyd loop in one kernel, one block per image
    (``csrc/slic_lloyd.cu``): K <= 128 and H*W*max(H, W) < 2^32;
  * ``"assign"``: the per-sweep loop -- the assignment kernel
    (``csrc/slic_assign.cu``) launched ``n_iter + 1`` times over tiles of
    pixels, with the shared fixed-point centre update between launches:
    any K <= 1024 and H*W < 2^27, the size of the full-resolution frames
    of the overlaps mode.
"""

from __future__ import annotations

import numpy as np
import torch

from spalign_tpu_torch.kernels.slic_assign import slic_assign
from spalign_tpu_torch.kernels.slic_fused import (pixel_rows, slic_lloyd,
                                                  update_centers)
from spalign_tpu_torch.utils.device import resolve_device


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB (0..1, (..., 3)) -> CIELAB (D65), standard colorimetry."""
    rgb = rgb.clamp(0.0, 1.0)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    xn, yn, zn = 0.950456, 1.0, 1.088754

    def f(t):
        return torch.where(t > 0.008856, t.pow(1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(x / xn), f(y / yn), f(z / zn)
    L = torch.where(y / yn > 0.008856, 116.0 * fy - 16.0, 903.3 * y / yn)
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return torch.stack([L, a, bb], dim=-1)


def _init_centers(h: int, w: int, n_segments: int):
    """Regular-grid centre positions: (centers_yx (gy*gx, 2) float32
    row-major, step, gy, gx)."""
    step = (h * w / n_segments) ** 0.5
    gy = max(1, int(round(h / step)))
    gx = max(1, int(round(w / step)))
    ys = (np.arange(gy) + 0.5) * (h / gy)
    xs = (np.arange(gx) + 0.5) * (w / gx)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return (np.stack([yy.ravel(), xx.ravel()], axis=-1).astype("float32"),
            step, gy, gx)


def slic_grid_size(h: int, w: int, n_segments: int) -> int:
    """The exact number of superpixels :func:`slic` produces for an
    (h, w) image: the regular-grid centre count."""
    return _init_centers(h, w, n_segments)[0].shape[0]


def slic_inputs(images: torch.Tensor, n_segments: int = 100,
                compactness: float = 10.0):
    """(B, H, W, 3) images (0..255) on their device -> the Lloyd loop's
    inputs: (lab (B, 3, H*W) float32 planar CIELAB, c0 (B, K, 5) float32
    grid centres L, a, b, y, x, dict(height, width, ratio, window))."""
    b, h, w, _ = images.shape
    dev = images.device
    centers_yx, step, _, _ = _init_centers(h, w, n_segments)
    k = centers_yx.shape[0]
    lab = rgb_to_lab(images.to(torch.float32) / 255.0)  # (B, H, W, 3)
    cyx = torch.from_numpy(centers_yx).to(dev)
    # LAB sampled at the int-truncated grid positions
    iy = cyx[:, 0].to(torch.int64).clamp(0, h - 1)
    ix = cyx[:, 1].to(torch.int64).clamp(0, w - 1)
    c0 = torch.cat([lab[:, iy, ix], cyx.expand(b, k, 2)], dim=-1)
    lab_planar = lab.permute(0, 3, 1, 2).reshape(b, 3, h * w)
    shape = dict(height=h, width=w,
                 ratio=float(((compactness / step) ** 2) ** 0.5),
                 window=float(2.0 * step))
    return lab_planar.contiguous(), c0.contiguous(), shape


# H*W bound of the per-sweep engine: its fixed-point sums (|v| < 2^26 a
# pixel) stay exact in the float64 centre update (the Lloyd engine's own
# bound, H*W*max(H, W) < 2^32, is tighter)
MAX_SWEEP_PIXELS = 2 ** 27


def slic_per_sweep(lab: torch.Tensor, c0: torch.Tensor, *, height: int,
                   width: int, n_iter: int, ratio: float,
                   window: float) -> torch.Tensor:
    """The per-sweep Lloyd loop (JAX ``kernels/slic.py:171-190``):
    ``n_iter`` times an assignment then the centre update, then a final
    assignment.  Same inputs and labels as ``slic_lloyd``."""
    if height * width >= MAX_SWEEP_PIXELS:
        raise ValueError(f"image {height}x{width} too large")
    if n_iter < 0:
        raise ValueError(f"n_iter={n_iter} must be >= 0")
    shape = dict(height=height, width=width, ratio=ratio, window=window)
    rows = pixel_rows(lab, width)
    centers = c0
    for _ in range(n_iter):
        centers = update_centers(rows, slic_assign(lab, centers, **shape),
                                 centers)
    return slic_assign(lab, centers, **shape)


ENGINES = {"lloyd": slic_lloyd, "assign": slic_per_sweep}


def slic(images, n_segments: int = 100, compactness: float = 10.0,
         n_iter: int = 10, engine: str = "lloyd",
         device="cuda") -> torch.Tensor:
    """SLIC superpixels of (B, H, W, 3) images with values 0..255.

    Returns a (B, H, W) int32 label map with ids in [0, K), K the grid
    size.  ``engine`` picks the Lloyd loop (see the module docstring); on
    CUDA it runs the engine's kernel, on the CPU its plain version."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {sorted(ENGINES)}, got "
                         f"{engine!r}")
    images = torch.as_tensor(images, device=resolve_device(device))
    b, h, w, _ = images.shape
    lab, c0, shape = slic_inputs(images, n_segments, compactness)
    return ENGINES[engine](lab, c0, n_iter=n_iter, **shape).reshape(b, h, w)
