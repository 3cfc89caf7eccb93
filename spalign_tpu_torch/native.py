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
    "spalign_encode_jpeg": (_I64, [_U8P, _I32, _I32, _I32, _U8P, _I64]),
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


def _jpeg_capacity(h: int, w: int) -> int:
    """Bytes that bound a baseline JPEG of (h, w): the headers, and for
    each of the 6 blocks of an MCU at most 27 bits of DC and 63 x 26 of
    AC, doubled for byte stuffing."""
    return 1024 + -(-h // 16) * -(-w // 16) * 6 * 420


def encode_jpeg_rgb(images: np.ndarray, quality: int):
    """Baseline JPEG (JFIF, YCbCr 4:2:0, IJG's integer "islow" DCT, the
    Annex K tables at IJG ``quality``) of an (H, W, 3) uint8 RGB image ->
    bytes, or of a batch (B, H, W, 3) -> a list of bytes, one image a
    thread (``csrc/host_ops.cpp`` ``spalign_encode_jpeg``)."""
    img = np.asarray(images)
    if img.dtype != np.uint8 or img.ndim not in (3, 4) or img.shape[-1] != 3:
        raise ValueError(f"encode_jpeg_rgb takes uint8 (H, W, 3) or "
                         f"(B, H, W, 3), got {img.dtype} {img.shape}")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"quality {quality} outside 1..100")
    batch = np.ascontiguousarray(img if img.ndim == 4 else img[None])
    b, h, w, _ = batch.shape
    if h > 65535 or w > 65535:
        raise ValueError(f"a JPEG holds at most 65535 x 65535, got {h} x {w}")
    cap = _jpeg_capacity(h, w)
    out = [None] * b
    lib = LIBRARY.get()

    def run(lo, hi):
        for i in range(lo, hi):
            buf = np.empty(cap, np.uint8)
            n = lib.spalign_encode_jpeg(batch[i].ctypes.data_as(_U8P), h, w,
                                        int(quality),
                                        buf.ctypes.data_as(_U8P), cap)
            if n < 0:
                raise ValueError(f"encode_jpeg: error {n}")
            out[i] = buf[:n].tobytes()

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


_JPEG_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_JPEG_BASE_QUANT = (np.array([  # Annex K.1, natural order
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32))
_JPEG_DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                 [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
_JPEG_AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
                 [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
_JPEG_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _jpeg_quant_tables(quality: int):
    """jcparam.c: the Annex K tables scaled by quality, baseline-clamped."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in _JPEG_BASE_QUANT]


def _jpeg_huff_codes(bits, vals):
    """Annex C: (code, length) indexed by symbol."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _jpeg_fdct_islow(blocks):
    """jfdctint.c over (..., 8, 8) int64 level-shifted samples: rows,
    then columns; coefficients scaled by 8."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, first):
        s = [d[..., i] for i in range(8)]
        t0, t7 = s[0] + s[7], s[0] - s[7]
        t1, t6 = s[1] + s[6], s[1] - s[6]
        t2, t5 = s[2] + s[5], s[2] - s[5]
        t3, t4 = s[3] + s[4], s[3] - s[4]
        t10, t13 = t0 + t3, t0 - t3
        t11, t12 = t1 + t2, t1 - t2
        sh = 13 - 2 if first else 13 + 2
        out = [None] * 8
        if first:
            out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
        else:
            out[0], out[4] = descale(t10 + t11, 2), descale(t10 - t11, 2)
        z1 = (t12 + t13) * 4433
        out[2] = descale(z1 + t13 * 6270, sh)
        out[6] = descale(z1 + t12 * -15137, sh)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = descale(t4 + z1 + z3, sh)
        out[5] = descale(t5 + z2 + z4, sh)
        out[3] = descale(t6 + z2 + z3, sh)
        out[1] = descale(t7 + z1 + z4, sh)
        return np.stack(out, -1)

    rows = one_pass(blocks, True)
    return np.swapaxes(one_pass(np.swapaxes(rows, -1, -2), False), -1, -2)


def _jpeg_coded_blocks(plane, quant):
    """(H, W) plane with H, W multiples of 8 -> (H/8, W/8, 64) quantized
    coefficients (jcdctmgr.c's rounding), natural order."""
    h, w = plane.shape
    blocks = plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2) - 128
    coef = _jpeg_fdct_islow(blocks).reshape(h // 8, w // 8, 64)
    div = quant.astype(np.int64) << 3
    q = (np.abs(coef) + (div >> 1)) // div
    return np.where(coef < 0, -q, q)


def _bit_length(a):
    a = np.abs(a)
    return sum((a >= (1 << i)).astype(np.int64) for i in range(16))


def encode_jpeg_rgb_reference(img: np.ndarray, quality: int) -> bytes:
    """Plain numpy version of :func:`encode_jpeg_rgb` for one image: the
    same integer arithmetic and edge rules, the entropy coder as sorted
    (code, length) events packed to bits."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    off = (128 << 16) + 32767
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off) >> 16
    mh, mw = -(-h // 16), -(-w // 16)
    xi = np.minimum(np.arange(mw * 16), w - 1)
    yp = y[np.minimum(np.arange(mh * 16), h - 1)][:, xi]
    hr = -(-h // 2)
    ri = np.minimum(np.arange(2 * hr), h - 1)
    bias = np.tile([1, 2], mw * 4)
    quant = _jpeg_quant_tables(int(quality))
    qc = []
    for c in (cb, cr):
        cx = c[ri][:, xi]
        d = (cx[0::2, 0::2] + cx[0::2, 1::2] + cx[1::2, 0::2]
             + cx[1::2, 1::2] + bias) >> 2
        qc.append(_jpeg_coded_blocks(
            d[np.minimum(np.arange(mh * 8), hr - 1)], quant[1]))
    qy = _jpeg_coded_blocks(yp, quant[0])  # (2 mh, 2 mw, 64)
    bw, bh = -(-w // 8), -(-h // 8)
    if bw % 2:  # dummy blocks at the right: the DC of the block before
        qy[:, bw] = 0
        qy[:, bw, 0] = qy[:, bw - 1, 0]
    if bh % 2:  # a dummy row: the DC of the MCU's top-right block
        qy[bh] = 0
        qy[bh, :, 0] = np.repeat(qy[bh - 1, 1::2, 0], 2)
    ymcu = qy.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        mh, mw, 4, 64)
    zz = np.concatenate([ymcu, qc[0][:, :, None], qc[1][:, :, None]],
                        2).reshape(-1, 64)[:, _JPEG_ZIGZAG]
    comp = np.tile([0, 0, 0, 0, 1, 2], mh * mw)
    table = np.minimum(comp, 1)
    n = len(zz)
    diff = np.empty(n, np.int64)
    for c in range(3):
        v = zz[comp == c, 0]
        diff[comp == c] = v - np.concatenate([[0], v[:-1]])
    dc = [_jpeg_huff_codes(_JPEG_DC_BITS[t], range(12)) for t in range(2)]
    ac = [_jpeg_huff_codes(_JPEG_AC_BITS[t], _JPEG_AC_VALS[t])
          for t in range(2)]

    def lookup(codes, tab, sym):
        return (np.where(tab == 0, codes[0][0][sym], codes[1][0][sym]),
                np.where(tab == 0, codes[0][1][sym], codes[1][1][sym]))

    def extra(v, nb):
        return np.where(v < 0, v - 1, v) & ((1 << nb) - 1)

    # events keyed by (block, position, order): DC, ZRLs, AC symbol, EOB
    nb = _bit_length(diff)
    code, length = lookup(dc, table, nb)
    keys, vals, lens = [np.arange(n) * 512], [(code << nb) | extra(diff, nb)], \
        [length + nb]
    bi, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[bi, k]
    first = np.concatenate([[True], bi[1:] != bi[:-1]])
    run = k - np.where(first, 0, np.concatenate([[0], k[:-1]])) - 1
    nb = _bit_length(v)
    code, length = lookup(ac, table[bi], ((run & 15) << 4) | nb)
    keys.append(bi * 512 + k * 8 + 4)
    vals.append((code << nb) | extra(v, nb))
    lens.append(length + nb)
    for z in range(1, 4):  # a ZRL for each 16 zeros of a run
        sel = run >= 16 * z
        code, length = lookup(ac, table[bi[sel]], 0xF0)
        keys.append(bi[sel] * 512 + k[sel] * 8 + z - 1)
        vals.append(code)
        lens.append(length)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    code, length = lookup(ac, table[eob], 0)
    keys.append(eob * 512 + 511)
    vals.append(code)
    lens.append(length)
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    pos = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = (np.repeat(vals, lens) >> (np.repeat(lens, lens) - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones((-len(bits)) % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8))
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0)
    out = bytearray(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01"
                    b"\x00\x01\x00\x00")
    for t, q in enumerate(quant):
        out += b"\xff\xdb\x00\x43" + bytes([t]) + bytes(
            q[_JPEG_ZIGZAG].astype(np.uint8))
    out += (b"\xff\xc0\x00\x11\x08" + h.to_bytes(2, "big")
            + w.to_bytes(2, "big") + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3,
                                             0x11, 1]))
    for t in range(2):
        for tc, bits_, vals_ in ((t, _JPEG_DC_BITS[t], range(12)),
                                 (0x10 | t, _JPEG_AC_BITS[t],
                                  _JPEG_AC_VALS[t])):
            seg = bytes([tc]) + bytes(bits_) + bytes(vals_)
            out += b"\xff\xc4" + (len(seg) + 2).to_bytes(2, "big") + seg
    out += b"\xff\xda\x00\x0c\x03\x01\x00\x02\x11\x03\x11\x00\x3f\x00"
    return bytes(out) + data.tobytes() + b"\xff\xd9"
