"""Superpixel-align: one pooled feature vector per superpixel.

Counterpart of ``spalign_tpu/ops/align.py`` (reference
batch_spalign_kmeans.py:210-276), batched over images: anchors from one
stable sort per image, bilinear interpolation of every anchor as one
gather, and a masked mean per superpixel.  The reference's "4 nearest
cells + bbox" is the enclosing 2x2 of cell centres, which the closed
form below computes with the reference's weight arithmetic.

The gather and the mean run over chunks of images whose (S, A, C)
temporaries fit ``ALIGN_CHUNK_BYTES``: at S = 1024 segments, A = 10
anchors and C = 512 channels one image's corner tensor alone is 21 MB,
and a unit of 150 images at once would hold several 3.1 GB tensors.
Each image's arithmetic is the same whatever the chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from spalign_tpu_torch.ops.segments import (center_of_mass,
                                            sample_segment_anchors,
                                            segment_sizes)

# device bytes the (chunk, S, A, C) temporaries of the align may hold
ALIGN_CHUNK_BYTES = 1 << 30
# float32 (S, A, C) tensors live at once per image: four corners, the
# weighted terms and their sum
_LIVE_TENSORS = 8


def align_chunk(s: int, a: int, c: int) -> int:
    """Images per chunk of the align's gather: as many as fit
    ALIGN_CHUNK_BYTES, at least one."""
    return max(1, ALIGN_CHUNK_BYTES // (_LIVE_TENSORS * 4 * s * a * c))


def bilinear_sample(feature_map: torch.Tensor,
                    points: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation on the cell-centre grid (centres at
    integer + 0.5, reference batch_spalign_kmeans.py:219-221).

    feature_map: (h, w, C) or (B, h, w, C); points: (..., 2) float (y, x)
    in feature-map coordinates clipped to [0.5, dim - 0.5], with the
    same leading B when the map has one.  Returns (..., C)."""
    batched = feature_map.dim() == 4
    fm = feature_map if batched else feature_map[None]
    pts = points if batched else points[None]
    b, h, w, c = fm.shape
    py, px = pts[..., 0], pts[..., 1]
    y0 = torch.floor(py - 0.5).clamp(0, h - 2).to(torch.int64)
    x0 = torch.floor(px - 0.5).clamp(0, w - 2).to(torch.int64)
    y1, x1 = y0 + 1, x0 + 1
    min_y = y0.to(pts.dtype) + 0.5
    min_x = x0.to(pts.dtype) + 0.5
    max_y = min_y + 1.0
    max_x = min_x + 1.0

    flat = fm.reshape(b, h * w, c)
    bidx = torch.arange(b, device=fm.device)[:, None]

    def at(yi, xi):
        return flat[bidx, (yi * w + xi).reshape(b, -1)].reshape(
            *yi.shape, c)

    f11, f12, f21, f22 = at(y0, x0), at(y1, x0), at(y0, x1), at(y1, x1)
    wy1 = (py - min_y)[..., None]
    wy0 = (max_y - py)[..., None]
    wx1 = (px - min_x)[..., None]
    wx0 = (max_x - px)[..., None]
    out = (wx0 * wy0 * f11 + wx0 * wy1 * f12 + wx1 * wy0 * f21
           + wx1 * wy1 * f22)
    return out if batched else out[0]


def superpixel_align(feature_maps: torch.Tensor, superpixels: torch.Tensor,
                     n_anchors: int, num_segments: int,
                     append_pos: bool = True, pos_scale: float = 1.0,
                     random_bits: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """Per-superpixel aligned feature vectors of a batch of images.

    Args:
      feature_maps: (B, hf, wf, C) float32.
      superpixels: (B, H, W) integer maps, ids in [0, num_segments).
      append_pos: append each superpixel's (y, x) centre of mass in image
        pixels (reference :269-270).
      pos_scale: image pixels per superpixel-map pixel (d for a map at
        1/d resolution); the centre of mass becomes ``com*d + (d-1)/2``.
      random_bits / generator: the anchor draws (see
        ``sample_segment_anchors``).

    Returns:
      features (B, S, C [+2]) float32, zeros for absent segments;
      valid (B, S) bool, True where the segment has a pixel.
    """
    img_h = superpixels.shape[-2]
    h_f, w_f = feature_maps.shape[1:3]
    feature_ratio = float(h_f) / float(img_h)

    anchor_yx, anchor_valid = sample_segment_anchors(
        superpixels, n_anchors, num_segments, random_bits=random_bits,
        generator=generator)
    pts = anchor_yx * feature_ratio + 0.5
    pts_y = pts[..., 0].clamp(0.0, h_f - 1 + 0.5)
    pts_x = pts[..., 1].clamp(0.0, w_f - 1 + 0.5)
    pts = torch.stack([pts_y, pts_x], -1)
    n_valid = anchor_valid.sum(-1).clamp(min=1)  # (B, S)
    b = feature_maps.shape[0]
    chunk = align_chunk(num_segments, n_anchors, feature_maps.shape[-1])
    means = []
    for lo in range(0, b, chunk):
        sl = slice(lo, lo + chunk)
        feats = bilinear_sample(feature_maps[sl], pts[sl])
        m = anchor_valid[sl, ..., None].to(feats.dtype)
        means.append((feats * m).sum(-2)
                     / n_valid[sl, ..., None].to(feats.dtype))
        del feats, m  # freed before the next chunk's gather
    mean_feat = torch.cat(means)
    if append_pos:
        com = center_of_mass(superpixels, num_segments)
        if pos_scale != 1.0:
            com = com * pos_scale + (pos_scale - 1.0) / 2.0
        mean_feat = torch.cat([mean_feat, com.to(mean_feat.dtype)], -1)
    valid = segment_sizes(superpixels.flatten(-2), num_segments) > 0
    return mean_feat, valid
