"""The host superpixel engines, the scorer and the image I/O: ctypes
bindings of ``csrc/host_ops.cpp``.

Counterpart of ``spalign_tpu/native/__init__.py`` with its call
conventions (the engines, the scorer and relabel's three passes:
``one_minus_f16``, ``confusion_remapped``, ``standardize_invert_u8``),
plus what the JAX package gets from cv2 on the host: the yuv420 wire
pack, PNG row un-filtering and the uint8 cubic resize.  The
library is built by g++ at first use (``kernels/_build.py``
``HostLibrary``); a failed build raises, and nothing falls back to the
plain numpy versions.  The ctypes calls release the GIL, so threads run
them in parallel: the batch functions split their images over up to
``HOST_THREADS`` threads.

``felzenszwalb_reference``, ``enforce_connectivity_reference``,
``png_unfilter_reference``, ``resize_cubic_u8_reference`` and the three
relabel ``*_reference`` functions are the plain numpy versions, for the
tests only (``pipeline/wire.py``'s
``pack_yuv420`` is the pack's).  ``felzenszwalb_reference`` equals the
library's partition without the blur (sigma = 0); with it the two blurs
round differently, and the segment counts agree within one.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from spalign_tpu_torch.kernels._build import HostLibrary

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64

LIBRARY = HostLibrary("host_ops", {
    "spalign_felzenszwalb": (_I32, [_F32P, _I32, _I32, _I32, ctypes.c_float,
                                    ctypes.c_float, _I32, _I32P]),
    "spalign_enforce_connectivity": (_I32, [_I32P, _I32, _I32, _I32, _I32P]),
    "spalign_confusion": (_I32, [_U8P, _I32, _I32, _U8P, _I32, _I32, _I64P]),
    "spalign_one_minus_f16": (_I32, [_U16P, _U16P, _I64]),
    "spalign_confusion_remapped": (_I32, [_U8P, _I32P, _I64, _I64P]),
    "spalign_standardize_invert": (_I32, [_F32P, _I64, _F32P, _F32P, _U8P]),
    "spalign_pack_yuv420": (_I32, [_U8P, _I32, _I32, _I32, _U8P]),
    "spalign_png_unfilter": (_I32, [_U8P, _I32, ctypes.c_int64, _I32, _U8P]),
    "spalign_resize_cubic_u8": (_I32, [_U8P, _I32, _I32, _I32, _I32, _I32,
                                       _I32, _U8P]),
})
HOST_THREADS = 8


def _split_batch(fn, n: int):
    """Run ``fn(begin, end)`` over [0, n) in contiguous slices, one per
    thread (at most HOST_THREADS and the cores)."""
    n_threads = max(1, min(HOST_THREADS, os.cpu_count() or 1, n))
    bounds = np.linspace(0, n, n_threads + 1).astype(int)
    if n_threads == 1:
        fn(0, n)
        return
    with ThreadPoolExecutor(n_threads) as ex:
        for f in [ex.submit(fn, int(a), int(b))
                  for a, b in zip(bounds[:-1], bounds[1:])]:
            f.result()


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


def one_minus_f16(x: np.ndarray) -> np.ndarray:
    """Elementwise ``1 - x`` of a float16 array through a 64K-entry bit
    table: relabel's channel 1 from channel 0, bit-equal to
    ``(1.0 - x.astype(float32)).astype(float16)``."""
    x = np.ascontiguousarray(x, dtype=np.float16)
    out = np.empty_like(x)
    if LIBRARY.get().spalign_one_minus_f16(
            x.view(np.uint16).ctypes.data_as(_U16P),
            out.view(np.uint16).ctypes.data_as(_U16P), x.size):
        raise ValueError("one_minus_f16: invalid arguments")
    return out


def confusion_remapped(pred_bool: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(2, 2) int64 conf[gt][pred] of a {0, 1} prediction against gt of
    the same size in {-1, 0, 1}; gt outside {0, 1} is void (relabel's
    per-image metrics)."""
    pred = np.ascontiguousarray(pred_bool, dtype=np.uint8)
    gt = np.ascontiguousarray(gt, dtype=np.int32)
    if pred.size != gt.size:
        raise ValueError(f"shape mismatch {pred.shape} vs {gt.shape}")
    out = np.empty((4,), np.int64)
    if LIBRARY.get().spalign_confusion_remapped(
            pred.ctypes.data_as(_U8P), gt.ctypes.data_as(_I32P), pred.size,
            out.ctypes.data_as(_I64P)):
        raise ValueError("confusion_remapped: invalid arguments")
    return out.reshape(2, 2)


def standardize_invert_u8(imgs: np.ndarray, mean, std) -> np.ndarray:
    """``clip(rint(imgs * std + mean), 0, 255)`` as uint8 of (..., 3)
    float32 images in one pass: relabel's uint8 wire, which recovers the
    pixels of standardized images."""
    imgs = np.ascontiguousarray(imgs, dtype=np.float32)
    if imgs.shape[-1] != 3:
        raise ValueError(f"expected trailing channel 3, got {imgs.shape}")
    mean3 = np.ascontiguousarray(np.broadcast_to(
        np.asarray(mean, np.float32), (3,)))
    std3 = np.ascontiguousarray(np.broadcast_to(
        np.asarray(std, np.float32), (3,)))
    out = np.empty(imgs.shape, np.uint8)
    if LIBRARY.get().spalign_standardize_invert(
            imgs.ctypes.data_as(_F32P), imgs.size // 3,
            mean3.ctypes.data_as(_F32P), std3.ctypes.data_as(_F32P),
            out.ctypes.data_as(_U8P)):
        raise ValueError("standardize_invert: invalid arguments")
    return out


def pack_yuv420(images_uint8: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 RGB -> (B, 1.5*H*W) uint8 yuv420 planes, bit-equal
    to ``pipeline/wire.pack_yuv420`` (its plain version)."""
    img = np.ascontiguousarray(images_uint8, dtype=np.uint8)
    b, h, w, c = img.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"yuv420 needs (B, H, W, 3) with H, W even, got "
                         f"{img.shape}")
    per = h * w + (h // 2) * (w // 2) * 2
    out = np.empty((b, per), np.uint8)
    lib = LIBRARY.get()

    def run(lo, hi):
        if lib.spalign_pack_yuv420(img[lo:hi].ctypes.data_as(_U8P), hi - lo,
                                   h, w, out[lo:hi].ctypes.data_as(_U8P)):
            raise ValueError("pack_yuv420: invalid arguments")

    _split_batch(run, b)
    return out


def png_unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Inflated PNG image data (h scanlines of a filter-type byte and
    ``row_bytes`` bytes) -> (h, row_bytes) uint8 un-filtered bytes."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (row_bytes + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, "
                         f"expected {h * (row_bytes + 1)}")
    out = np.empty((h, row_bytes), np.uint8)
    rc = LIBRARY.get().spalign_png_unfilter(
        data.ctypes.data_as(_U8P), h, row_bytes, bpp,
        out.ctypes.data_as(_U8P))
    if rc <= -2:
        raise ValueError(f"PNG row {-2 - rc} has an unknown filter type")
    if rc < 0:
        raise ValueError("png_unfilter: invalid arguments")
    return out


def resize_cubic_u8(images: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_CUBIC) of uint8 images
    with cv2's default arithmetic (``csrc/host_ops.cpp``
    ``spalign_resize_cubic_u8``).  ``images``: (H, W, C) or a batch
    (B, H, W, C); the result has the same layout at ``out_hw``.  Images
    already at ``out_hw`` are returned as they are."""
    img = np.asarray(images)
    if img.dtype != np.uint8 or img.ndim not in (3, 4):
        raise ValueError(f"resize_cubic_u8 takes uint8 (H, W, C) or "
                         f"(B, H, W, C), got {img.dtype} {img.shape}")
    h, w = (int(v) for v in out_hw)
    if img.shape[-3:-1] == (h, w):
        return images
    batch = np.ascontiguousarray(img if img.ndim == 4 else img[None])
    b, in_h, in_w, c = batch.shape
    out = np.empty((b, h, w, c), np.uint8)
    lib = LIBRARY.get()

    def run(lo, hi):
        if lib.spalign_resize_cubic_u8(batch[lo:hi].ctypes.data_as(_U8P),
                                       hi - lo, in_h, in_w, c, h, w,
                                       out[lo:hi].ctypes.data_as(_U8P)):
            raise ValueError("resize_cubic_u8: invalid arguments")

    _split_batch(run, b)
    return out if img.ndim == 4 else out[0]


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


def png_unfilter_reference(raw: bytes, h: int, row_bytes: int,
                           bpp: int) -> np.ndarray:
    """Plain numpy version of :func:`png_unfilter`."""
    data = np.frombuffer(raw, np.uint8).reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.int32)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(h):
        ft, src = int(data[y, 0]), data[y, 1:].astype(np.int32)
        cur = out[y]
        if ft == 0:
            cur[:] = src
        elif ft == 2:
            cur[:] = (src + prev) & 255
        elif ft in (1, 3, 4):
            for x0 in range(0, row_bytes, bpp):
                sl = slice(x0, x0 + bpp)
                a = cur[x0 - bpp:x0] if x0 >= bpp else 0
                b = prev[sl]
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x0 - bpp:x0] if x0 >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[sl] = (src[sl] + pred) & 255
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type")
        prev = cur
    return out.astype(np.uint8)


def _cubic_taps_reference(n_out: int, n_in: int):
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f)
    x = f - s
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                  n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float32)


def resize_cubic_u8_reference(img: np.ndarray, out_hw) -> np.ndarray:
    """Plain numpy version of :func:`resize_cubic_u8` for one (H, W, C)
    image."""
    x = np.asarray(img).astype(np.float32)
    iy, cy = _cubic_taps_reference(out_hw[0], x.shape[0])
    ix, cx = _cubic_taps_reference(out_hw[1], x.shape[1])
    t = cy[:, 0, None, None] * x[iy[:, 0]]
    for k in range(1, 4):
        t = t + cy[:, k, None, None] * x[iy[:, k]]
    o = cx[None, :, 0, None] * t[:, ix[:, 0]]
    for k in range(1, 4):
        o = o + cx[None, :, k, None] * t[:, ix[:, k]]
    return np.clip(np.rint(o), 0, 255).astype(np.uint8)


def one_minus_f16_reference(x: np.ndarray) -> np.ndarray:
    """Plain numpy version of :func:`one_minus_f16`."""
    return (1.0 - np.asarray(x, np.float16).astype(np.float32)).astype(
        np.float16)


def confusion_remapped_reference(pred_bool: np.ndarray,
                                 gt: np.ndarray) -> np.ndarray:
    """Plain numpy version of :func:`confusion_remapped`."""
    gt_i = np.clip(np.asarray(gt).astype(np.int64), -1, 2)  # void: -1, 2
    idx = ((gt_i + 1) * 2 + np.asarray(pred_bool).astype(bool)).ravel()
    c = np.bincount(idx, minlength=8)
    return np.array([[c[2], c[3]], [c[4], c[5]]], np.int64)


def standardize_invert_u8_reference(imgs: np.ndarray, mean,
                                    std) -> np.ndarray:
    """Plain numpy version of :func:`standardize_invert_u8`."""
    imgs = np.asarray(imgs, np.float32)
    return np.clip(np.rint(imgs * np.asarray(std, np.float32)
                           + np.asarray(mean, np.float32)),
                   0, 255).astype(np.uint8)
