"""One SLIC assignment step, with the next centre update's sums fused in:
a hand-written Hopper kernel and its plain version.

Counterpart of ``spalign_tpu/kernels/experimental/slic_pallas.py`` (the
Pallas ``_assign_kernel`` behind ``slic_assign_pallas``), which the JAX
package runs once per sweep in ``slic(use_pallas=True)``.
``slic_assign`` launches ``csrc/slic_assign.cu`` for CUDA tensors and runs
the plain version only for CPU tensors: ``slic_assign_reference`` for the
labels, ``center_sums`` of those labels for the sums.

Inputs (both versions):
  lab:     (B, 3, H*W) float32 planar CIELAB (L, a, b planes).
  centers: (B, K, 5) float32 centres, rows L, a, b, y, x; any K >= 1.
Output: (B, H*W) int32 labels, or with ``sums=True`` the (B, K, 6) int64
sums of the next centre update (``center_sums``) and no labels.

Semantics: the score p.c - |c|^2/2 over L, a, b, y*ratio, x*ratio (the
argmin of the TPU kernel's squared distance up to rounding); only centres
within the Chebyshev ``window`` of the pixel's raw (y, x) compete, the
lowest id wins ties, and an empty window falls back to the unmasked
argmax.  The arithmetic is that of the Lloyd kernel
(``kernels/slic_fused.py``), so a sweep of either engine gives the same
labels bit for bit.

Both SLIC kernels score a pixel only against the candidate centres of its
warp's strip of pixels (``STRIP``: 4 rows of a 32 x 32 tile, 32 columns);
the assignment kernel first stages, per 32 x 32 tile (``TILE``), the
centres near the tile, at most ``STAGE_CAP`` of them (a tile with more
scans every centre from device memory).  ``tile_candidates`` is that
filter in plain PyTorch, for the tests, at either size.  The
centre update both engines share is here too: ``center_sums`` (the plain
version of the fused sums), ``centers_from_sums`` and their composition
``update_centers``.  The kernel takes H, W <= 2^20.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spalign_tpu_torch.kernels._build import CudaLibrary

# a warp's strip of pixels (rows, columns) in both SLIC kernels, fixed in
# csrc/slic_tile.cuh (4 of a block's 32 x 32 tile), and the block's tile
STRIP = (4, 32)
TILE = (32, 32)
# the centres a block of the assignment kernel stages at most
# (csrc/slic_assign.cu kStageCap)
STAGE_CAP = 512
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("slic_assign", {
    # (lab, centers, labels, sums, B, H, W, K, ratio, window, stream)
    "spalign_slic_assign": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _F, _F, _P]),
})
# pixel x centre elements the plain version materializes per chunk
_PLAIN_CHUNK = 1 << 25


def check_inputs(lab: torch.Tensor, centers: torch.Tensor, height: int,
                 width: int, max_centers: Optional[int] = None):
    """Shapes, types and sizes both SLIC engines take (raises):
    ``max_centers`` None for no bound on K."""
    if lab.dim() != 3 or lab.shape[1] != 3 or lab.shape[2] != height * width:
        raise ValueError(f"lab must be (B, 3, {height * width}), got "
                         f"{tuple(lab.shape)}")
    if (centers.dim() != 3 or centers.shape[0] != lab.shape[0]
            or centers.shape[2] != 5):
        raise ValueError(f"centers must be (B, K, 5), got "
                         f"{tuple(centers.shape)}")
    k = centers.shape[1]
    if k < 1 or (max_centers is not None and k > max_centers):
        raise ValueError(f"K={k} centres; the kernel takes "
                         f"1..{max_centers or 'any'}")
    if lab.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("lab and centers must be float32")
    if lab.device != centers.device:
        raise ValueError("lab and centers must be on the same device")


def slic_assign(lab: torch.Tensor, centers: torch.Tensor, *, height: int,
                width: int, ratio: float, window: float,
                sums: bool = False) -> torch.Tensor:
    """One assignment step; CUDA tensors go through the kernel.  Returns
    the labels, or with ``sums=True`` only the next update's sums."""
    check_inputs(lab, centers, height, width)
    if lab.device.type == "cpu":
        labels = slic_assign_reference(lab, centers, height=height,
                                       width=width, ratio=ratio,
                                       window=window)
        return (center_sums(pixel_rows(lab, width), labels, centers) if sums
                else labels)
    if lab.device.type != "cuda":
        raise ValueError(f"unsupported device {lab.device}")
    if not (lab.is_contiguous() and centers.is_contiguous()):
        raise ValueError("lab and centers must be contiguous")
    fn = LIBRARY.get().spalign_slic_assign
    b, k = lab.shape[0], centers.shape[1]
    if sums:
        out = torch.zeros((b, k, 6), dtype=torch.int64, device=lab.device)
        ptrs = (None, out.data_ptr())
    else:
        out = torch.empty((b, height * width), dtype=torch.int32,
                          device=lab.device)
        ptrs = (out.data_ptr(), None)
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        err = fn(lab.data_ptr(), centers.data_ptr(), *ptrs, b, height, width,
                 k, float(ratio), float(window), stream)
    if err != 0:
        raise RuntimeError(f"slic_assign kernel launch failed: CUDA error "
                           f"{err}")
    slic_assign.launches += 1
    if sums:
        slic_assign.sums_launches += 1
    return out


# kernel launches, for proof of the path taken: all of them, and those
# of the sums-only form
slic_assign.launches = 0
slic_assign.sums_launches = 0


def slic_assign_reference(lab: torch.Tensor, centers: torch.Tensor, *,
                          height: int, width: int, ratio: float,
                          window: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: float32 products and sums
    without contraction, in the kernel's order, over chunks of images and
    pixels of at most ``_PLAIN_CHUNK`` (pixel, centre) pairs.  Its labels
    equal the kernel's bit for bit."""
    check_inputs(lab, centers, height, width)
    b, _, hw = lab.shape
    k = centers.shape[1]
    dev = lab.device
    f32 = torch.float32
    ratio_t = torch.tensor(ratio, dtype=f32, device=dev)
    window_t = torch.tensor(window, dtype=f32, device=dev)
    pix = torch.arange(hw, device=dev)
    py = torch.div(pix, width, rounding_mode="floor")
    fy, fx = py.to(f32), (pix - py * width).to(f32)
    pyr, pxr = fy * ratio_t, fx * ratio_t
    cl, ca, cb = centers[..., 0], centers[..., 1], centers[..., 2]
    cy, cx = centers[..., 3], centers[..., 4]
    cyr, cxr = cy * ratio_t, cx * ratio_t
    half = 0.5 * (cl * cl + ca * ca + cb * cb + cyr * cyr + cxr * cxr)
    cent = (cl, ca, cb, cyr, cxr, half, cy, cx)
    px_chunk = min(hw, max(1, _PLAIN_CHUNK // k))
    img_chunk = max(1, _PLAIN_CHUNK // (px_chunk * k))
    labels = torch.empty((b, hw), dtype=torch.int32, device=dev)
    for i in range(0, b, img_chunk):
        j = min(i + img_chunk, b)
        for s in range(0, hw, px_chunk):
            e = min(s + px_chunk, hw)
            labels[i:j, s:e] = _assign(
                lab[i:j, :, s:e], pyr[s:e], pxr[s:e], fy[s:e], fx[s:e],
                [t[i:j] for t in cent], window_t)
    return labels


def _assign(lab, pyr, pxr, fy, fx, cent, window):
    """(b, n) labels for a chunk of images and pixels: argmax of the score
    among the centres in the window, lowest id on ties, unmasked argmax
    when the window is empty."""
    cl, ca, cb, cyr, cxr, half, cy, cx = (t[:, None, :] for t in cent)
    pl, pa, pb = (lab[:, i, :, None] for i in range(3))
    score = (cl * pl + ca * pa + cb * pb + cyr * pyr[None, :, None]
             + cxr * pxr[None, :, None] - half)  # (b, n, K)
    in_win = (((fy[None, :, None] - cy).abs() <= window)
              & ((fx[None, :, None] - cx).abs() <= window))
    masked = torch.where(in_win, score, float("-inf"))
    return torch.where(in_win.any(-1), masked.argmax(-1), score.argmax(-1))


def tile_candidates(centers: torch.Tensor, height: int, width: int,
                    tile: tuple, window: float) -> torch.Tensor:
    """The kernels' candidate filter in plain PyTorch: (B, tiles, K) bool
    over the grid of (rows, columns) ``tile`` blocks of pixels (the
    kernels' strips are ``STRIP``, the assignment kernel's staging
    ``TILE``), in row-major order.  A centre
    is a candidate of a tile when its raw (y, x) lie within the tile's
    pixel rows and columns, cut at the image's edge, widened by
    ``window + 1``, in the float32 expressions of ``csrc/slic_tile.cuh``:
    a superset of the centres any pixel of the tile has in its window."""
    th, tw = tile
    f32 = torch.float32
    dev = centers.device
    pad = torch.tensor(window, dtype=f32, device=dev) + 1.0

    def span(n, t):  # each tile's widened bounds along one axis
        first = torch.arange(0, n, t, device=dev)
        last = (first + t).clamp(max=n) - 1
        return first.to(f32) - pad, last.to(f32) + pad

    lo_y, hi_y = span(height, th)
    lo_x, hi_x = span(width, tw)
    cy, cx = centers[:, None, :, 3], centers[:, None, :, 4]
    in_y = (cy >= lo_y[:, None]) & (cy <= hi_y[:, None])  # (B, tiles_y, K)
    in_x = (cx >= lo_x[:, None]) & (cx <= hi_x[:, None])  # (B, tiles_x, K)
    b, k = centers.shape[:2]
    return (in_y[:, :, None] & in_x[:, None]).reshape(b, -1, k)


def pixel_rows(lab: torch.Tensor, width: int) -> torch.Tensor:
    """(6, B*H*W) float64 per-pixel addends of the centre update, all
    integers (exact below 2^53): round(L * 2^16), round(a * 2^16),
    round(b * 2^16), y, x, 1.  Loop-invariant: made once per SLIC
    call."""
    b, _, hw = lab.shape
    f64 = torch.float64
    pix = torch.arange(hw, device=lab.device)
    py = torch.div(pix, width, rounding_mode="floor")
    q = torch.round(lab * 65536.0).to(f64)  # (B, 3, HW)
    ints = torch.stack([py, pix - py * width, torch.ones_like(py)]).to(f64)
    return torch.cat([q.transpose(0, 1).reshape(3, b * hw),
                      ints.repeat(1, b)])


def center_sums(rows: torch.Tensor, labels: torch.Tensor,
                centers: torch.Tensor) -> torch.Tensor:
    """(B, K, 6) int64 sums of each centre's members: fixed-point L, a, b,
    then y, x and the count.  ``bincount`` sums them in float64, exact
    while they stay below 2^53, so they equal the kernel's integer
    atomics whatever their order.  The plain version of the fused sums.

    rows: ``pixel_rows``; labels (B, H*W) of the sweep; centers
    (B, K, 5)."""
    b, k, _ = centers.shape
    ids = (labels.to(torch.int64)
           + (torch.arange(b, device=labels.device) * k)[:, None]).reshape(-1)
    sums = torch.stack([torch.bincount(ids, weights=r, minlength=b * k)
                        for r in rows])
    return sums.T.reshape(b, k, 6).to(torch.int64)


def centers_from_sums(sums: torch.Tensor,
                      centers: torch.Tensor) -> torch.Tensor:
    """Every centre moves to the mean of its members, an empty one stays:
    the means taken in float64 and rounded to float32, as the Lloyd
    kernel does.  sums (B, K, 6) int64 (``center_sums``); centers
    (B, K, 5).  Returns (B, K, 5)."""
    b, k, _ = centers.shape
    s = sums.reshape(b * k, 6).T.to(torch.float64)
    n = s[5:]
    mean = torch.cat([s[:3] / n / 65536.0, s[3:5] / n]).to(torch.float32).T
    return torch.where(n.T > 0, mean, centers.reshape(b * k, 5)).reshape(
        b, k, 5).contiguous()


def update_centers(rows: torch.Tensor, labels: torch.Tensor,
                   centers: torch.Tensor) -> torch.Tensor:
    """The centre update both SLIC engines share, in plain PyTorch:
    ``centers_from_sums`` of ``center_sums``."""
    return centers_from_sums(center_sums(rows, labels, centers), centers)
