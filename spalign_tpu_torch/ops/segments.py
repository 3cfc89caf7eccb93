"""Segment (superpixel) reductions and anchor sampling.

Counterpart of ``spalign_tpu/ops/segments.py``.  Every function takes
per-image segment ids with any number of leading batch dimensions
(``(..., N)`` or maps ``(..., H, W)``) and reduces each image on its own:
ids are offset by ``image * num_segments`` and reduced with ``index_add_``
into ``B * num_segments`` bins in one call.  Counts are integer sums of
ones, so they are exact and, unlike ``bincount`` on the card, read
nothing back to the host (a unit's program can be captured as a CUDA
graph).  Float sums accumulate in float64 and round once to float32, so
their order (atomics on the card) does not change the result.
"""

from __future__ import annotations

from typing import Optional

import torch


def _flat_ids(segment_ids: torch.Tensor, num_segments: int):
    """(..., N) ids -> (flat offset ids (B*N,), leading shape, B)."""
    lead = tuple(segment_ids.shape[:-1])
    b = 1
    for d in lead:
        b *= d
    ids = segment_ids.reshape(b, -1).to(torch.int64)
    ids = ids + (torch.arange(b, device=ids.device) * num_segments)[:, None]
    return ids.reshape(-1), lead, b


def _counts(ids: torch.Tensor, bins: int) -> torch.Tensor:
    """(bins,) int64 occurrences of each flat id in [0, bins)."""
    counts = torch.zeros(bins, dtype=torch.int64, device=ids.device)
    return counts.index_add_(0, ids, torch.ones_like(ids))


def segment_sizes(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """(..., N) ids -> (..., S) int32 count of elements per segment."""
    ids, lead, b = _flat_ids(segment_ids, num_segments)
    counts = _counts(ids, b * num_segments)
    return counts.reshape(*lead, num_segments).to(torch.int32)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean of ``data`` per segment.  data: (..., N) or (..., N, C), ids
    (..., N).  Absent segments get 0 (not NaN).  Float data keeps its
    dtype; other data gives float32."""
    vector = data.dim() == segment_ids.dim()
    ids, lead, b = _flat_ids(segment_ids, num_segments)
    d = data.reshape(ids.shape[0], -1).to(torch.float64)
    sums = torch.zeros((b * num_segments, d.shape[1]), dtype=torch.float64,
                       device=d.device)
    sums.index_add_(0, ids, d)
    counts = _counts(ids, b * num_segments)
    out = sums / counts.clamp(min=1)[:, None].to(torch.float64)
    dtype = data.dtype if data.is_floating_point() else torch.float32
    out = out.to(dtype).reshape(*lead, num_segments, d.shape[1])
    return out[..., 0] if vector else out


def center_of_mass(superpixels: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """(..., H, W) maps -> (..., S, 2) float32 per-segment (y, x) mean of
    member pixel coordinates (scipy.ndimage center_of_mass of each mask,
    reference batch_spalign_kmeans.py:229); 0 for absent segments."""
    h, w = superpixels.shape[-2:]
    dev = superpixels.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    lead = superpixels.shape[:-2]
    coords = torch.stack([yy, xx], -1).reshape(h * w, 2)
    coords = coords.expand(*lead, h * w, 2)
    return segment_mean(coords, superpixels.reshape(*lead, h * w),
                        num_segments)


def anchor_key_bits(num_segments: int) -> int:
    """Random bits below the segment id in the composite sort key."""
    return 31 - max(1, int(num_segments - 1).bit_length())


def exact_permutation(num_segments: int) -> bool:
    """True when the anchor sort key takes a permutation of the pixels in
    place of random bits: fewer than 15 bits are left below the ids."""
    return anchor_key_bits(num_segments) < 15


def draw_anchor_bits(b: int, n: int, num_segments: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """The random minor keys of ``b`` images of ``n`` pixels: (b, n)
    integers in [0, 2**anchor_key_bits), or one ``torch.randperm(n)``
    per image on the exact-permutation path."""
    if exact_permutation(num_segments):
        return torch.stack([torch.randperm(n, generator=generator,
                                           device=device)
                            for _ in range(b)])
    return torch.randint(0, 2 ** anchor_key_bits(num_segments), (b, n),
                         generator=generator, device=device)


def sample_segment_anchors(superpixels: torch.Tensor, n_anchors: int,
                           num_segments: int,
                           random_bits: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None):
    """Up to ``n_anchors`` distinct random pixels per segment.

    One stable sort per image by the composite key
    ``segment_id << avail | random_bits`` groups each segment's pixels in
    random order; the first ``n_anchors`` of each group, found from the
    per-segment start offsets, are its anchors (all of them when the
    segment is smaller — the reference's ``shuffle(...)[:n_select]``,
    batch_spalign_kmeans.py:230-234).  When the segment ids leave fewer
    than 15 random bits (``num_segments`` > 65536), the key is
    ``segment_id * n + perm`` instead, ``perm`` a permutation of the n
    pixels (the JAX package's exact-permutation path); its domain is the
    JAX package's, ``num_segments * n < 2**31``.

    Args:
      superpixels: (..., H, W) integer maps, ids in [0, num_segments).
      random_bits: optional (..., H*W) integers in [0, 2**avail),
        ``avail = anchor_key_bits(num_segments)``, or on the
        exact-permutation path one permutation of range(H*W) per image;
        drawn from ``generator`` when absent.

    Returns:
      anchor_yx: (..., S, A, 2) float32 pixel coordinates (y, x).
      anchor_valid: (..., S, A) bool.
    """
    h, w = superpixels.shape[-2:]
    lead = tuple(superpixels.shape[:-2])
    n = h * w
    ids = superpixels.reshape(-1, n).to(torch.int64)
    b = ids.shape[0]
    if random_bits is None:
        random_bits = draw_anchor_bits(b, n, num_segments,
                                       generator=generator,
                                       device=ids.device)
    random_bits = random_bits.reshape(b, n).to(torch.int64)
    if exact_permutation(num_segments):
        if num_segments * n >= 2 ** 31:
            raise ValueError(
                f"num_segments={num_segments} x {n} pixels: the composite "
                "sort key overflows int32")
        composite = ids * n + random_bits
    else:
        composite = ids * (2 ** anchor_key_bits(num_segments)) + random_bits
    order = torch.sort(composite, dim=1, stable=True).indices

    counts = segment_sizes(ids, num_segments).to(torch.int64)  # (b, S)
    starts = torch.cumsum(counts, dim=1) - counts
    offs = torch.arange(n_anchors, device=ids.device)
    gather_idx = (starts[..., None] + offs).clamp(0, n - 1)  # (b, S, A)
    anchor_valid = offs < counts[..., None]
    flat_pix = order.gather(1, gather_idx.reshape(b, -1)).reshape(
        b, num_segments, n_anchors)
    ay = torch.div(flat_pix, w, rounding_mode="floor").to(torch.float32)
    ax = (flat_pix % w).to(torch.float32)
    anchor_yx = torch.stack([ay, ax], -1)
    return (anchor_yx.reshape(*lead, num_segments, n_anchors, 2),
            anchor_valid.reshape(*lead, num_segments, n_anchors))
