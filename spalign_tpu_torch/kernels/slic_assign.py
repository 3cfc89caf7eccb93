"""One SLIC assignment step: a hand-written Hopper kernel and its plain
version.

Counterpart of ``spalign_tpu/kernels/experimental/slic_pallas.py`` (the
Pallas ``_assign_kernel`` behind ``slic_assign_pallas``), which the JAX
package runs once per sweep in ``slic(use_pallas=True)``.
``slic_assign`` launches ``csrc/slic_assign.cu`` for CUDA tensors and runs
``slic_assign_reference`` only for CPU tensors.

Inputs (both versions):
  lab:     (B, 3, H*W) float32 planar CIELAB (L, a, b planes).
  centers: (B, K, 5) float32 centres, rows L, a, b, y, x; K <= 1024.
Output: (B, H*W) int32 labels.

Semantics: the score p.c - |c|^2/2 over L, a, b, y*ratio, x*ratio (the
argmin of the TPU kernel's squared distance up to rounding); only centres
within the Chebyshev ``window`` of the pixel's raw (y, x) compete, the
lowest id wins ties, and an empty window falls back to the unmasked
argmax.  The arithmetic is that of the Lloyd kernel
(``kernels/slic_fused.py``), so a sweep of either engine gives the same
labels bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from spalign_tpu_torch.kernels._build import CudaLibrary

MAX_CENTERS = 1024
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("slic_assign", {
    # (lab, centers, labels, B, H, W, K, ratio, window, stream)
    "spalign_slic_assign": (ctypes.c_int, [_P, _P, _P, _I, _I, _I, _I,
                                           _F, _F, _P]),
})
# pixel x centre elements the plain version materializes per chunk
_PLAIN_CHUNK = 1 << 26


def check_inputs(lab: torch.Tensor, centers: torch.Tensor, height: int,
                 width: int, max_centers: int = MAX_CENTERS):
    """Shapes, types and sizes both SLIC engines take (raises)."""
    if lab.dim() != 3 or lab.shape[1] != 3 or lab.shape[2] != height * width:
        raise ValueError(f"lab must be (B, 3, {height * width}), got "
                         f"{tuple(lab.shape)}")
    if (centers.dim() != 3 or centers.shape[0] != lab.shape[0]
            or centers.shape[2] != 5):
        raise ValueError(f"centers must be (B, K, 5), got "
                         f"{tuple(centers.shape)}")
    if not 0 < centers.shape[1] <= max_centers:
        raise ValueError(f"K={centers.shape[1]} centres; the kernel takes "
                         f"1..{max_centers}")
    if lab.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("lab and centers must be float32")
    if lab.device != centers.device:
        raise ValueError("lab and centers must be on the same device")


def slic_assign(lab: torch.Tensor, centers: torch.Tensor, *, height: int,
                width: int, ratio: float, window: float) -> torch.Tensor:
    """One assignment step; CUDA tensors go through the kernel."""
    check_inputs(lab, centers, height, width)
    if lab.device.type == "cpu":
        return slic_assign_reference(lab, centers, height=height,
                                     width=width, ratio=ratio, window=window)
    if lab.device.type != "cuda":
        raise ValueError(f"unsupported device {lab.device}")
    if not (lab.is_contiguous() and centers.is_contiguous()):
        raise ValueError("lab and centers must be contiguous")
    fn = LIBRARY.get().spalign_slic_assign
    b, k = lab.shape[0], centers.shape[1]
    labels = torch.empty((b, height * width), dtype=torch.int32,
                         device=lab.device)
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        err = fn(lab.data_ptr(), centers.data_ptr(), labels.data_ptr(), b,
                 height, width, k, float(ratio), float(window), stream)
    if err != 0:
        raise RuntimeError(f"slic_assign kernel launch failed: CUDA error "
                           f"{err}")
    slic_assign.launches += 1
    return labels


slic_assign.launches = 0  # kernel launches, for proof of the path taken


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
