"""The SLIC Lloyd loop: a hand-written Hopper kernel and its plain version.

Counterpart of ``spalign_tpu/kernels/slic_fused.py`` (the Pallas
``_lloyd_kernel``).  ``slic_lloyd`` launches ``csrc/slic_lloyd.cu`` for
CUDA tensors and runs ``slic_lloyd_reference`` only for CPU tensors.

Inputs (both versions):
  lab: (B, 3, H*W) float32 planar CIELAB (L, a, b planes).
  c0:  (B, K, 5) float32 initial centres, rows L, a, b, y, x; K <= 128.
Output: (B, H*W) int32 labels of the final assignment.

Semantics (the TPU kernel's): the score p.c - |c|^2/2 over L, a, b,
y*ratio, x*ratio; only centres within the Chebyshev ``window`` of the
pixel's raw (y, x) compete, the lowest id wins ties, an empty window
falls back to the unmasked argmax; ``n_iter`` centre updates
(``cnt > 0 ? sum / cnt : old``), then one final assignment.  Centre
coordinates are means of the integer pixel coordinates, and their
scaled copies are ``mean * ratio``.
"""

from __future__ import annotations

import ctypes

import torch

from spalign_tpu_torch.kernels._build import CudaLibrary

MAX_CENTERS = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("slic_lloyd", {
    # (lab, c0, labels, B, H, W, K, n_iter, ratio, window, stream)
    "spalign_slic_lloyd": (ctypes.c_int, [_P, _P, _P, _I, _I, _I, _I, _I,
                                          _F, _F, _P]),
})
# pixel x centre elements the plain version materializes per chunk
_PLAIN_CHUNK = 1 << 26


def _check(lab: torch.Tensor, c0: torch.Tensor, height: int, width: int,
           n_iter: int):
    if lab.dim() != 3 or lab.shape[1] != 3 or lab.shape[2] != height * width:
        raise ValueError(f"lab must be (B, 3, {height * width}), got "
                         f"{tuple(lab.shape)}")
    if c0.dim() != 3 or c0.shape[0] != lab.shape[0] or c0.shape[2] != 5:
        raise ValueError(f"c0 must be (B, K, 5), got {tuple(c0.shape)}")
    if not 0 < c0.shape[1] <= MAX_CENTERS:
        raise ValueError(f"K={c0.shape[1]} centres; the kernel takes "
                         f"1..{MAX_CENTERS}")
    if lab.dtype != torch.float32 or c0.dtype != torch.float32:
        raise TypeError("lab and c0 must be float32")
    if lab.device != c0.device:
        raise ValueError("lab and c0 must be on the same device")
    if n_iter < 0:
        raise ValueError(f"n_iter={n_iter} must be >= 0")
    # integer coordinate sums must fit 32 bits
    if height * width * max(height, width) >= 2 ** 32:
        raise ValueError(f"image {height}x{width} too large")


def slic_lloyd(lab: torch.Tensor, c0: torch.Tensor, *, height: int,
               width: int, n_iter: int, ratio: float,
               window: float) -> torch.Tensor:
    """Run the SLIC Lloyd loop; CUDA tensors go through the kernel."""
    _check(lab, c0, height, width, n_iter)
    if lab.device.type == "cpu":
        return slic_lloyd_reference(lab, c0, height=height, width=width,
                                    n_iter=n_iter, ratio=ratio,
                                    window=window)
    if lab.device.type != "cuda":
        raise ValueError(f"unsupported device {lab.device}")
    if not (lab.is_contiguous() and c0.is_contiguous()):
        raise ValueError("lab and c0 must be contiguous")
    fn = LIBRARY.get().spalign_slic_lloyd
    b, k = lab.shape[0], c0.shape[1]
    labels = torch.empty((b, height * width), dtype=torch.int32,
                         device=lab.device)
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        err = fn(lab.data_ptr(), c0.data_ptr(), labels.data_ptr(), b,
                 height, width, k, n_iter, float(ratio), float(window),
                 stream)
    if err != 0:
        raise RuntimeError(f"slic_lloyd kernel launch failed: CUDA error "
                           f"{err}")
    slic_lloyd.launches += 1
    return labels


slic_lloyd.launches = 0  # kernel launches, for proof of the path taken


def slic_lloyd_reference(lab: torch.Tensor, c0: torch.Tensor, *,
                         height: int, width: int, n_iter: int,
                         ratio: float, window: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the same arithmetic in the
    same order: float32 products and sums without contraction for the
    score and |c|^2/2, fixed-point (2^16) int64 sums of L, a, b, integer
    sums of y, x and the counts, centre means in float64 rounded to
    float32.  Its labels equal the kernel's bit for bit."""
    _check(lab, c0, height, width, n_iter)
    b, _, hw = lab.shape
    k = c0.shape[1]
    dev = lab.device
    f32 = torch.float32
    ratio_t = torch.tensor(ratio, dtype=f32, device=dev)
    window_t = torch.tensor(window, dtype=f32, device=dev)
    pix = torch.arange(hw, device=dev)
    py = torch.div(pix, width, rounding_mode="floor")
    px = pix - py * width
    fy, fx = py.to(f32), px.to(f32)
    pl, pa, pb = lab[:, 0], lab[:, 1], lab[:, 2]  # (B, HW)
    pyr, pxr = fy * ratio_t, fx * ratio_t
    q = torch.round(lab * 65536.0).to(torch.int64)  # (B, 3, HW)
    ints = torch.stack([py, px, torch.ones_like(py)], -1).expand(b, hw, 3)
    centers = c0.clone()  # (B, K, 5): L, a, b, y, x
    ids_base = (torch.arange(b, device=dev) * k)[:, None]
    chunk = max(1, _PLAIN_CHUNK // max(1, hw * k))
    for it in range(n_iter + 1):
        cl, ca, cb = centers[..., 0], centers[..., 1], centers[..., 2]
        cy, cx = centers[..., 3], centers[..., 4]
        cyr, cxr = cy * ratio_t, cx * ratio_t
        half = 0.5 * (cl * cl + ca * ca + cb * cb + cyr * cyr + cxr * cxr)
        labels = torch.cat([
            _assign(pl[i:j], pa[i:j], pb[i:j], pyr, pxr, fy, fx,
                    [t[i:j] for t in (cl, ca, cb, cyr, cxr, half, cy, cx)],
                    window_t)
            for i, j in ((i, min(i + chunk, b)) for i in range(0, b, chunk))])
        if it == n_iter:
            return labels.to(torch.int32)
        ids = (labels + ids_base).reshape(-1)
        qsum = torch.zeros((b * k, 3), dtype=torch.int64, device=dev)
        qsum.index_add_(0, ids, q.transpose(1, 2).reshape(-1, 3))
        isum = torch.zeros((b * k, 3), dtype=torch.int64, device=dev)
        isum.index_add_(0, ids, ints.reshape(-1, 3))
        n = isum[:, 2:].to(torch.float64)
        mean = torch.cat([qsum.to(torch.float64) / n / 65536.0,
                          isum[:, :2].to(torch.float64) / n], -1).to(f32)
        centers = torch.where(n > 0, mean, centers.reshape(b * k, 5)
                              ).reshape(b, k, 5)


def _assign(pl, pa, pb, pyr, pxr, fy, fx, cent, window):
    """(b, HW) labels for a chunk of images: argmax of the score among
    the centres in the window, lowest id on ties, unmasked argmax when
    the window is empty."""
    cl, ca, cb, cyr, cxr, half, cy, cx = (t[:, None, :] for t in cent)
    pl, pa, pb = pl[..., None], pa[..., None], pb[..., None]
    score = (cl * pl + ca * pa + cb * pb + cyr * pyr[None, :, None]
             + cxr * pxr[None, :, None] - half)  # (b, HW, K)
    in_win = (((fy[None, :, None] - cy).abs() <= window)
              & ((fx[None, :, None] - cx).abs() <= window))
    masked = torch.where(in_win, score, float("-inf"))
    return torch.where(in_win.any(-1), masked.argmax(-1), score.argmax(-1))
