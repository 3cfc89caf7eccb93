"""Superpixel frontend: one interface, two engines.

Counterpart of ``spalign_tpu/pipeline/superpixels.py``.

- 'felzenszwalb': the native host op (``native.felzenszwalb``, the
  reference's headline configuration, batch_spalign_kmeans.py:301-307:
  scale 300, sigma 0.8, min size 20), fanned out over a thread pool (the
  ctypes calls release the GIL).
- 'slic': SLIC on the device (``kernels/slic.py``), the Lloyd kernel at
  network resolution and the per-sweep engine on full-resolution frames
  (``engine_for``), then, unless ``slic_enforce_connectivity`` is off,
  the host connectivity pass (``native.enforce_connectivity``, min size
  H*W / (4 * n_slic_segments)).

``compute_superpixels`` returns (B, H, W) int32 maps with per-image
contiguous ids in [0, counts[i]) and the counts.  The device variants
``batched_slic_device*`` (the per-sweep engine, for the full-resolution
frames of the overlaps mode's device SLIC frontend) return int32 maps
that stay on the device, where the overlaps refine consumes them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from spalign_tpu_torch import native
from spalign_tpu_torch.config import SuperpixelConfig
from spalign_tpu_torch.kernels.slic import engine_for, slic, slic_grid_size
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


def _host_workers(cap: int = 8) -> int:
    """Threads of the host superpixel passes: no more than the cores."""
    return max(1, min(cap, os.cpu_count() or 1))


def _host_map(fn, items):
    if len(items) == 1:
        return np.stack([fn(items[0])])
    with ThreadPoolExecutor(max_workers=_host_workers()) as ex:
        return np.stack(list(ex.map(fn, items)))


def _felzenszwalb_batch(images_hwc: np.ndarray, cfg: SuperpixelConfig):
    def one(img):
        return native.felzenszwalb(
            img.astype(np.float32) / 255.0, scale=cfg.felzenszwalb_scale,
            sigma=cfg.felzenszwalb_sigma, min_size=cfg.felzenszwalb_min_size)

    return _host_map(one, images_hwc)


def _slic_batch(images: torch.Tensor, cfg: SuperpixelConfig) -> np.ndarray:
    """Device SLIC, downloaded at the narrowest width that holds its
    ids, then the host connectivity pass."""
    h, w = images.shape[1:3]
    k = slic_grid_size(h, w, cfg.n_slic_segments)
    labels = slic(images, n_segments=cfg.n_slic_segments,
                  compactness=cfg.slic_compactness, n_iter=cfg.slic_iters,
                  engine=engine_for(h, w, k), device=images.device)
    narrow = torch.uint8 if k <= 2 ** 8 else torch.int16
    labels = labels.to(narrow).cpu().numpy().astype(np.int32)
    if not cfg.slic_enforce_connectivity:
        return labels
    min_size = max(1, (h * w) // (cfg.n_slic_segments * 4))
    return _host_map(lambda lab: native.enforce_connectivity(
        lab, min_size=min_size), labels)


def compute_superpixels(images_hwc, cfg: SuperpixelConfig, device="cuda",
                        device_images=None):
    """(B, H, W, 3) uint8 RGB (host) -> (superpixels (B, H, W) int32 with
    contiguous ids per image, counts (B,) int32), on the host.

    device_images: the same batch already on the device (the SLIC engine
    takes it and skips the upload); SLIC runs on the current stream.
    Raises when an image has more than ``cfg.max_superpixels``."""
    dev = resolve_device(device)
    images_hwc = np.asarray(images_hwc)
    if cfg.method == "felzenszwalb":
        maps = _felzenszwalb_batch(images_hwc, cfg)
    elif cfg.method == "slic":
        if device_images is None:
            device_images = torch.from_numpy(
                np.ascontiguousarray(images_hwc)).to(dev)
        maps = _slic_batch(device_images, cfg)
    else:
        raise ValueError(f"unknown superpixel method: {cfg.method!r}")
    counts = maps.max(axis=(1, 2)) + 1
    if counts.max() > cfg.max_superpixels:
        raise ValueError(
            f"image produced {counts.max()} superpixels > bound "
            f"{cfg.max_superpixels}; raise SuperpixelConfig.max_superpixels")
    return maps.astype(np.int32), counts.astype(np.int32)
