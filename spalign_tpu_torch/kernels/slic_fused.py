"""The SLIC Lloyd loop: a hand-written Hopper kernel and its plain version.

Counterpart of ``spalign_tpu/kernels/slic_fused.py`` (the Pallas
``_lloyd_kernel``).  ``slic_lloyd`` launches ``csrc/slic_lloyd.cu`` for
CUDA tensors, one thread-block cluster per image (``cluster_size``), and
runs ``slic_lloyd_reference`` only for CPU tensors.

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
import functools

import torch

from spalign_tpu_torch.kernels._build import CudaLibrary
from spalign_tpu_torch.kernels.slic_assign import (check_inputs,
                                                   pixel_rows,
                                                   slic_assign_reference,
                                                   update_centers)

MAX_CENTERS = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("slic_lloyd", {
    # (B, H, W) -> CTAs per image
    "spalign_slic_lloyd_cluster": (ctypes.c_int, [_I, _I, _I]),
    # (lab, c0, labels, B, H, W, K, n_iter, ratio, window, cluster, stream)
    "spalign_slic_lloyd": (ctypes.c_int, [_P, _P, _P, _I, _I, _I, _I, _I,
                                          _F, _F, _I, _P]),
})


def _check(lab: torch.Tensor, c0: torch.Tensor, height: int, width: int,
           n_iter: int):
    check_inputs(lab, c0, height, width, MAX_CENTERS)
    if n_iter < 0:
        raise ValueError(f"n_iter={n_iter} must be >= 0")
    # integer coordinate sums must fit 32 bits
    if height * width * max(height, width) >= 2 ** 32:
        raise ValueError(f"image {height}x{width} too large")


def cluster_size(n_images: int, height: int, width: int) -> int:
    """CTAs per image in the Lloyd kernel's launch on the current CUDA
    device: the largest of 16, 8, 4, 2 that is at most the image's tile
    count and with which all ``n_images`` clusters are resident on the
    card at once (``cudaOccupancyMaxActiveClusters``), else 1.  So a
    batch of 30 large frames spreads each frame over several SMs, and the
    150 images of a bench unit still run in one wave.  Cached: the query
    costs more host time than a launch."""
    return _cluster_size(torch.cuda.current_device(), n_images, height,
                         width)


@functools.lru_cache(maxsize=None)
def _cluster_size(device: int, n_images: int, height: int,
                  width: int) -> int:
    c = LIBRARY.get().spalign_slic_lloyd_cluster(n_images, height, width)
    if c <= 0:
        raise RuntimeError(f"slic_lloyd cluster query failed: CUDA error "
                           f"{-c}")
    return c


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
        cluster = cluster_size(b, height, width)
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        err = fn(lab.data_ptr(), c0.data_ptr(), labels.data_ptr(), b,
                 height, width, k, n_iter, float(ratio), float(window),
                 cluster, stream)
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
