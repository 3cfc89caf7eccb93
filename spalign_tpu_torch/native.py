"""The host superpixel engines and the scorer: ctypes bindings of
``csrc/host_ops.cpp``.

Counterpart of ``spalign_tpu/native/__init__.py`` with its call
conventions.  The library is built by g++ at first use
(``kernels/_build.py`` ``HostLibrary``); a failed build raises, and
nothing falls back to the plain numpy versions.  The ctypes calls
release the GIL, so threads run them in parallel.

``felzenszwalb_reference`` and ``enforce_connectivity_reference`` are the
plain numpy versions (copies of the JAX package's fallbacks), for the
tests only: slow Python loops.  ``felzenszwalb_reference`` equals the
library's partition without the blur (sigma = 0); with it the two blurs
round differently, and the segment counts agree within one.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spalign_tpu_torch.kernels._build import HostLibrary

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.c_int32

LIBRARY = HostLibrary("host_ops", {
    "spalign_felzenszwalb": (_I32, [_F32P, _I32, _I32, _I32, ctypes.c_float,
                                    ctypes.c_float, _I32, _I32P]),
    "spalign_enforce_connectivity": (_I32, [_I32P, _I32, _I32, _I32, _I32P]),
    "spalign_confusion": (_I32, [_U8P, _I32, _I32, _U8P, _I32, _I32, _I64P]),
})


def felzenszwalb(img_hwc: np.ndarray, scale: float = 300.0,
                 sigma: float = 0.8, min_size: int = 20) -> np.ndarray:
    """Felzenszwalb-Huttenlocher segmentation of an (H, W, C) float image
    (skimage's call convention: the reference passes img / 255.).
    Returns (H, W) int32 labels, contiguous by first raster occurrence."""
    img = np.ascontiguousarray(img_hwc, dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    out = np.empty((h, w), dtype=np.int32)
    n = LIBRARY.get().spalign_felzenszwalb(
        img.ctypes.data_as(_F32P), h, w, c, ctypes.c_float(scale),
        ctypes.c_float(sigma), min_size, out.ctypes.data_as(_I32P))
    if n < 0:
        raise ValueError("felzenszwalb: invalid arguments")
    return out


def enforce_connectivity(labels: np.ndarray, min_size: int = 1) -> np.ndarray:
    """Split label regions into 4-connected components and absorb the
    components below ``min_size`` into a neighbour (the post-pass of
    device SLIC).  Returns (H, W) int32 contiguous labels."""
    lab = np.ascontiguousarray(labels, dtype=np.int32)
    h, w = lab.shape
    out = np.empty_like(lab)
    n = LIBRARY.get().spalign_enforce_connectivity(
        lab.ctypes.data_as(_I32P), h, w, min_size, out.ctypes.data_as(_I32P))
    if n < 0:
        raise ValueError("enforce_connectivity: invalid arguments")
    return out


def confusion_vs_labelids(pred_small: np.ndarray,
                          label_ids_full: np.ndarray) -> np.ndarray:
    """(2, 2) int64 conf[gt][pred] of a road mask against full-resolution
    raw Cityscapes labelIds (void ids 0..6 ignored) in one pass: the
    NN upsample (float32 index convention of ``ops/resize.nn_resize_cv2``),
    the remap and the counts."""
    pred = np.ascontiguousarray(pred_small, dtype=np.uint8)
    gt = np.ascontiguousarray(label_ids_full, dtype=np.uint8)
    if pred.ndim != 2 or gt.ndim != 2:
        raise ValueError(f"expected 2-D maps, got {pred.shape}, {gt.shape}")
    out = np.empty((4,), np.int64)
    rc = LIBRARY.get().spalign_confusion(
        pred.ctypes.data_as(_U8P), *pred.shape, gt.ctypes.data_as(_U8P),
        *gt.shape, out.ctypes.data_as(_I64P))
    if rc < 0:
        raise ValueError("confusion_vs_labelids: invalid arguments")
    return out.reshape(2, 2)


# ------------------------- plain numpy versions ----------------------------


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x):
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def merge(self, a, b):
        a, b = self.find(a), self.find(b)
        if a == b:
            return a
        if self.size[a] < self.size[b]:
            a, b = b, a
        self.parent[b] = a
        self.size[a] += self.size[b]
        return a


def _gaussian_np(plane, sigma):
    if sigma <= 0:
        return plane
    radius = max(1, int(np.ceil(4.0 * sigma)))
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    k /= k.sum()
    pad = np.pad(plane, radius, mode="reflect")
    tmp = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, pad)
    return np.apply_along_axis(lambda col: np.convolve(col, k, "valid"), 0,
                               tmp)


def _first_occurrence_ids(roots) -> np.ndarray:
    """Component roots -> int32 ids numbered by first raster occurrence."""
    seen = {}
    out = np.empty(len(roots), dtype=np.int32)
    for i, r in enumerate(roots):
        out[i] = seen.setdefault(int(r), len(seen))
    return out


def felzenszwalb_reference(img_hwc: np.ndarray, scale: float = 300.0,
                           sigma: float = 0.8,
                           min_size: int = 20) -> np.ndarray:
    """Plain numpy version of :func:`felzenszwalb`."""
    img = np.asarray(img_hwc, dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    sm = np.stack([_gaussian_np(img[:, :, ch], sigma) for ch in range(c)],
                  axis=-1)
    flat = sm.reshape(-1, c)
    n = h * w
    idx = np.arange(n).reshape(h, w)
    pairs = []
    for dy, dx in [(0, 1), (1, 0), (1, 1), (1, -1)]:
        a = idx[0:h - dy, max(0, -dx):w - max(0, dx)].ravel()
        pairs.append(np.stack([a, a + dy * w + dx], axis=1))
    edges = np.concatenate(pairs)
    wts = np.sqrt(((flat[edges[:, 0]] - flat[edges[:, 1]]) ** 2).sum(1))
    order = np.argsort(wts, kind="stable")
    uf = _UnionFind(n)
    thr = np.full(n, scale, dtype=np.float64)
    for e in order:
        a, b = uf.find(edges[e, 0]), uf.find(edges[e, 1])
        if a == b:
            continue
        wt = wts[e]
        if wt <= thr[a] and wt <= thr[b]:
            m = uf.merge(a, b)
            thr[m] = wt + scale / uf.size[m]
    if min_size > 1:
        for e in order:
            a, b = uf.find(edges[e, 0]), uf.find(edges[e, 1])
            if a != b and (uf.size[a] < min_size or uf.size[b] < min_size):
                uf.merge(a, b)
    return _first_occurrence_ids([uf.find(i) for i in range(n)]).reshape(h, w)


def enforce_connectivity_reference(labels: np.ndarray,
                                   min_size: int = 1) -> np.ndarray:
    """Plain numpy version of :func:`enforce_connectivity`."""
    lab = np.asarray(labels, dtype=np.int32)
    h, w = lab.shape
    n = h * w
    uf = _UnionFind(n)
    flat = lab.ravel()
    idx = np.arange(n)
    right = idx[(idx % w) < w - 1]
    down = idx[idx < n - w]
    for a, b in [(right, right + 1), (down, down + w)]:
        same = flat[a] == flat[b]
        for x, y in zip(a[same], b[same]):
            uf.merge(x, y)
    if min_size > 1:
        changed = True
        while changed:
            changed = False
            for p in range(n):
                rp = uf.find(p)
                if uf.size[rp] >= min_size:
                    continue
                best, best_size = -1, -1
                y, x = divmod(p, w)
                for q in (p - 1 if x > 0 else -1, p + 1 if x < w - 1 else -1,
                          p - w if y > 0 else -1, p + w if y < h - 1 else -1):
                    if q < 0:
                        continue
                    rq = uf.find(q)
                    if rq != rp and uf.size[rq] > best_size:
                        best, best_size = rq, uf.size[rq]
                if best >= 0:
                    uf.merge(rp, best)
                    changed = True
    return _first_occurrence_ids([uf.find(i) for i in range(n)]).reshape(h, w)
