"""Gaussian road-location prior (reference batch_spalign_kmeans.py:111-129).

Counterpart of ``spalign_tpu/ops/prior.py``: a Gaussian at
(int(H*0.75), int(W*0.5)) with the reference's ``(2*sigma)**2``
denominator, averaged per superpixel.
"""

from __future__ import annotations

import torch

from spalign_tpu_torch.ops.segments import segment_mean


def pixel_prior(h: int, w: int, y_rel_pos: float = 0.75,
                x_rel_pos: float = 0.5, y_rel_sigma: float = 0.1,
                x_rel_sigma: float = 0.1, *, device) -> torch.Tensor:
    """(h, w) float32 per-pixel prior on ``device`` (no default: the
    caller names it), with the integer truncation of the mean position
    (reference :116-122)."""
    ycoord = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xcoord = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    ymean = float(int(h * y_rel_pos))
    xmean = float(int(w * x_rel_pos))
    y_sigma = h * y_rel_sigma
    x_sigma = w * x_rel_sigma
    return torch.exp(-((ycoord - ymean) ** 2 / (2.0 * y_sigma) ** 2
                       + (xcoord - xmean) ** 2 / (2.0 * x_sigma) ** 2))


def superpixel_prior(superpixels: torch.Tensor, num_segments: int,
                     y_rel_pos: float = 0.75, x_rel_pos: float = 0.5,
                     y_rel_sigma: float = 0.1,
                     x_rel_sigma: float = 0.1) -> torch.Tensor:
    """(..., H, W) maps -> (..., S) float32 mean pixel prior per
    superpixel; 0 for absent ids (reference :124-127)."""
    h, w = superpixels.shape[-2:]
    weights = pixel_prior(h, w, y_rel_pos, x_rel_pos, y_rel_sigma,
                          x_rel_sigma, device=superpixels.device)
    lead = superpixels.shape[:-2]
    return segment_mean(weights.reshape(-1).expand(*lead, h * w),
                        superpixels.reshape(*lead, h * w), num_segments)
