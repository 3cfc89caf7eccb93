"""Superpixel frontend: device SLIC of full batches.

Counterpart of ``spalign_tpu/pipeline/superpixels.py``.  The device
variants return int32 label maps that stay on the device (the overlaps
refine consumes them there); they run the per-sweep SLIC engine
(``kernels/slic.py``, engine ``"assign"``), which takes full-resolution
frames and any K up to 1024.

Not ported yet (``compute_superpixels`` raises ``NotImplementedError``):
the host engines, felzenszwalb and SLIC with the connectivity pass.
"""

from __future__ import annotations

import numpy as np
import torch

from spalign_tpu_torch.config import SuperpixelConfig
from spalign_tpu_torch.kernels.slic import slic
from spalign_tpu_torch.pipeline.wire import decode_yuv420
from spalign_tpu_torch.utils.device import resolve_device


def batched_slic_device(n_segments: int, compactness: float, n_iter: int):
    """(B, H, W, 3) images (0..255) on the device -> (B, H, W) int32
    SLIC maps on the same device."""
    def run(images: torch.Tensor) -> torch.Tensor:
        return slic(images, n_segments=n_segments, compactness=compactness,
                    n_iter=n_iter, engine="assign", device=images.device)

    return run


def batched_slic_device_yuv(n_segments: int, compactness: float,
                            n_iter: int, hw):
    """``batched_slic_device`` of yuv420-packed batches (``pipeline/
    wire.py``): (B, 1.5*H*W) uint8 on the device, decoded there."""
    run = batched_slic_device(n_segments, compactness, n_iter)

    def run_yuv(packed: torch.Tensor) -> torch.Tensor:
        return run(decode_yuv420(packed, tuple(hw)))

    return run_yuv


def compute_superpixels(images_hwc, cfg: SuperpixelConfig, device="cuda"):
    """(B, H, W, 3) uint8 RGB (host) -> (superpixels (B, H, W) int32 with
    contiguous ids per image, counts (B,) int32), on the host.

    Only the device SLIC engine (method 'slic' without the connectivity
    pass) is ported."""
    if cfg.method == "felzenszwalb":
        raise NotImplementedError("the felzenszwalb engine is not ported")
    if cfg.method != "slic":
        raise ValueError(f"unknown superpixel method: {cfg.method!r}")
    if cfg.slic_enforce_connectivity:
        raise NotImplementedError(
            "SLIC's host connectivity pass is not ported")
    images = torch.from_numpy(np.ascontiguousarray(images_hwc)).to(
        resolve_device(device))
    maps = batched_slic_device(cfg.n_slic_segments, cfg.slic_compactness,
                               cfg.slic_iters)(images).cpu().numpy()
    counts = maps.max(axis=(1, 2)) + 1
    if counts.max() > cfg.max_superpixels:
        raise ValueError(
            f"image produced {counts.max()} superpixels > bound "
            f"{cfg.max_superpixels}; raise SuperpixelConfig.max_superpixels")
    return maps.astype(np.int32), counts.astype(np.int32)
