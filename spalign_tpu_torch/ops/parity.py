"""Bit-parity machinery: exact reproduction of the reference's host-side
randomness and float64 prior.

The port's copy of ``spalign_tpu/ops/parity.py`` (numpy only), line for
line: the anchor replay must consume the ``random.shuffle`` stream
exactly as the reference does.

The reference seeds the process-global numpy RNG once
(``np.random.seed(1111)``, batch_spalign_kmeans.py:33-35) and consumes it
inside the k-means init shuffle (:146-149).  The default device pipeline
uses a distribution-identical device shuffle instead (ops/kmeans.py); this
module provides the *parity mode* pieces that replay the reference's
stream bit-for-bit:

  * :func:`reference_seed_assignment` — the literal init rule on the
    compact (concatenated-over-images) weight vector, consuming a legacy
    ``np.random.RandomState`` exactly like ``np.random.shuffle``;
  * :func:`superpixel_prior_host` — the reference's float64 host prior
    (batch_create_prior runs on host numpy, :333-344, and is only then
    shipped to the device).

SpalignLabelGenerator wires these in when ``KMeansConfig.init ==
"reference"``: DRN features on the device -> anchor replay, align, prior
and init on the host -> Lloyd loop on the device via
weighted_kmeans_from_init.
"""

from __future__ import annotations

import numpy as np


def reference_seed_assignment(weights: np.ndarray, k: int,
                              rng: np.random.RandomState) -> np.ndarray:
    """Initial k-means assignment, bit-identical to the reference
    (batch_spalign_kmeans.py:141-149).

    Args:
      weights: (N,) compact prior weights — superpixels of all images of
        the batch concatenated in image order (no padding), exactly the
        array the reference feeds to ``kmeans``.
      k: number of clusters.
      rng: legacy RandomState; its MT19937 stream matches the
        process-global ``np.random`` the reference seeds with 1111, so
        ``RandomState(1111)`` consumed once per clustering reproduces the
        reference's first clustering of a run.

    Returns: (N,) int32 initial assignment.
    """
    n = weights.shape[0]
    assign = np.zeros((n,), dtype=np.int64)
    # float(sort(w)[n // 2]) — the reference's exact median rule (:144)
    prior_weight_threshold = float(np.sort(weights)[n // 2])
    # assign[weights > thr] = 0 is a no-op on a zeros array (:145)
    cond = weights <= prior_weight_threshold
    idx = np.arange(int(cond.sum())) % (k - 1) + 1
    rng.shuffle(idx)
    assign[cond] = idx
    return assign.astype(np.int32)


def reference_superpixel_align(feature_map_hwc: np.ndarray,
                               superpixels: np.ndarray, pyrng,
                               n_select: int = 10, n_neighbor: int = 4,
                               append_pos: bool = False) -> np.ndarray:
    """Host replay of the reference's superpixel_align, bit-for-bit
    (batch_spalign_kmeans.py:210-276) — including its python-stdlib
    ``random`` anchor shuffle (module seeded 1111 at :33; :232 is the
    ONLY consumer of that stream in the process, so replaying it here
    reproduces the full-run anchor sequence exactly).

    feature_map_hwc: (hf, wf, C) float32 (the reference indexes CHW;
      only the layout differs).
    superpixels: (H, W) int map at input resolution.
    pyrng: a ``random.Random`` replica of the reference's module-global
      stream, consumed ONE ``shuffle`` per superpixel in ascending-id,
      image-after-image order.

    Returns (n_superpixels, C[+2]) float64 compact rows (the reference's
    CPU/numpy dtype flow: float64 coords x float32 features -> float64).
    """
    hf, wf = feature_map_hwc.shape[:2]
    feature_ratio = float(hf) / superpixels.shape[0]
    # the reference builds flat_ft_coords via meshgrid(arange(h),
    # arange(w)) with default 'xy' indexing: (w, h)-shaped grids whose
    # FLAT ORDER is x-major — np.argsort tie-breaks depend on it, so it
    # is reproduced literally
    yy, xx = np.meshgrid(np.arange(hf), np.arange(wf))
    flat_ft_coords = (np.stack([yy, xx]).transpose(1, 2, 0)
                      + 0.5).reshape(-1, 2)

    rows = []
    for idx in np.sort(np.unique(superpixels)):
        mask = superpixels == idx
        if append_pos:
            ys, xs = np.nonzero(mask)
            centroid = (ys.mean(), xs.mean())  # scipy center_of_mass
        y, x = np.where(mask)
        inside_coords = list(zip(y.tolist(), x.tolist()))
        pyrng.shuffle(inside_coords)
        pts = np.asarray(inside_coords, dtype=np.float64)[:n_select]
        pts *= feature_ratio
        pts += 0.5  # use center of pixels
        pts[:, 0] = np.clip(pts[:, 0], 0, hf - 1 + 0.5)
        pts[:, 1] = np.clip(pts[:, 1], 0, wf - 1 + 0.5)
        feats = []
        for p in pts:
            py, px = p
            dist = np.sqrt(((flat_ft_coords - p[None, :]) ** 2).sum(1))
            nb = flat_ft_coords[np.argsort(dist)[:n_neighbor]]
            max_y, max_x = nb.max(axis=0)
            min_y, min_x = nb.min(axis=0)
            # the reference asserts a non-degenerate 2x2 cell (:250-255)
            assert max_x > min_x and max_y > min_y, (p, nb)
            f11 = feature_map_hwc[int(min_y), int(min_x)]
            f12 = feature_map_hwc[int(max_y), int(min_x)]
            f21 = feature_map_hwc[int(min_y), int(max_x)]
            f22 = feature_map_hwc[int(max_y), int(max_x)]
            fp = (max_x - px) * (max_y - py) * f11
            fp = fp + (max_x - px) * (py - min_y) * f12
            fp = fp + (px - min_x) * (max_y - py) * f21
            fp = fp + (px - min_x) * (py - min_y) * f22
            fp = 1.0 / ((max_x - min_x) * (max_y - min_y)) * fp
            if append_pos:
                fp = np.hstack([fp, np.array(centroid)])
            feats.append(fp)
        rows.append(np.mean(np.stack(feats), axis=0))
    return np.stack(rows)


def pixel_prior_host(h: int, w: int, y_rel_pos: float = 0.75,
                     x_rel_pos: float = 0.5, y_rel_sigma: float = 0.1,
                     x_rel_sigma: float = 0.1) -> np.ndarray:
    """Reference create_prior pixel weights in float64
    (batch_spalign_kmeans.py:116-122): integer-truncated mean position
    and the (2*sigma)**2 denominator."""
    xcoord, ycoord = np.meshgrid(np.arange(w), np.arange(h))
    ymean, xmean = int(h * y_rel_pos), int(w * x_rel_pos)
    y_sigma = h * y_rel_sigma
    x_sigma = w * x_rel_sigma
    return np.exp(-((ycoord - ymean) ** 2 / (2 * y_sigma) ** 2
                    + (xcoord - xmean) ** 2 / (2 * x_sigma) ** 2))


def superpixel_prior_host(superpixels: np.ndarray,
                          y_rel_pos: float = 0.75, x_rel_pos: float = 0.5,
                          y_rel_sigma: float = 0.1,
                          x_rel_sigma: float = 0.1) -> np.ndarray:
    """Per-superpixel mean pixel prior of ONE image, float64, in the
    reference's exact formulation (weights[superpixels == idx].mean()
    per ascending id, batch_spalign_kmeans.py:124-127).

    Returns a COMPACT (n_superpixels,) float64 vector (no padding)."""
    weights = pixel_prior_host(superpixels.shape[0], superpixels.shape[1],
                               y_rel_pos, x_rel_pos, y_rel_sigma,
                               x_rel_sigma)
    return np.asarray([weights[superpixels == idx].mean()
                       for idx in np.sort(np.unique(superpixels))])
