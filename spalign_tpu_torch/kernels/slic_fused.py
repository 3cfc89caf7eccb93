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
from spalign_tpu_torch.kernels.slic_assign import (check_inputs,
                                                   slic_assign_reference)

MAX_CENTERS = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("slic_lloyd", {
    # (lab, c0, labels, B, H, W, K, n_iter, ratio, window, stream)
    "spalign_slic_lloyd": (ctypes.c_int, [_P, _P, _P, _I, _I, _I, _I, _I,
                                          _F, _F, _P]),
})


def _check(lab: torch.Tensor, c0: torch.Tensor, height: int, width: int,
           n_iter: int):
    check_inputs(lab, c0, height, width, MAX_CENTERS)
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
    same order: ``slic_assign_reference`` for each assignment and
    ``update_centers`` between them.  Its labels equal the kernel's bit
    for bit."""
    _check(lab, c0, height, width, n_iter)
    rows = pixel_rows(lab, width)
    centers = c0
    shape = dict(height=height, width=width, ratio=ratio, window=window)
    for _ in range(n_iter):
        labels = slic_assign_reference(lab, centers, **shape)
        centers = update_centers(rows, labels, centers)
    return slic_assign_reference(lab, centers, **shape)


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


def update_centers(rows: torch.Tensor, labels: torch.Tensor,
                   centers: torch.Tensor) -> torch.Tensor:
    """The centre update both SLIC engines share: every centre moves to
    the mean of its members, an empty one stays.  The sums are integers
    (fixed-point L, a, b; y, x and the counts) summed by ``bincount`` in
    float64, exact while they stay below 2^53, so they do not depend on
    the order of the card's atomics; the means are taken in float64 and
    rounded to float32, as the Lloyd kernel does.

    rows: ``pixel_rows``; labels (B, H*W) of the sweep; centers
    (B, K, 5).  Returns (B, K, 5)."""
    b, k, _ = centers.shape
    ids = (labels.to(torch.int64)
           + (torch.arange(b, device=labels.device) * k)[:, None]).reshape(-1)
    sums = torch.stack([torch.bincount(ids, weights=r, minlength=b * k)
                        for r in rows])
    n = sums[5:]
    mean = torch.cat([sums[:3] / n / 65536.0, sums[3:5] / n]).to(
        torch.float32).T
    return torch.where(n.T > 0, mean, centers.reshape(b * k, 5)).reshape(
        b, k, 5).contiguous()
