"""Plain superpixel-align label generation (Tsutsui et al. 2018,
batch_spalign_kmeans.py), written from the configuration, in torch and
numpy with no kernel of the program: the yuv420 wire, SLIC, anchor
sampling and align, the Gaussian prior, prior-seeded weighted k-means,
painting, and the scorer against full-resolution labelIds.

Precisions: SLIC scores and the k-means in float32, matmuls with TF32
off, segment sums in float64.  The controls: ``slic(..., score_dtype=
torch.bfloat16)`` (the scores in bfloat16) and the k-means with TF32 on
(``tf32=True``).

Random draws follow the configuration's seeding: each clustering group
seeds a ``torch.Generator`` on the device with its seed, draws the anchor
keys of its images (``randint`` below 2**(31 - bits(K - 1)), one row of
H*W per image), then the seeding uniforms (one per superpixel slot).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# --- the yuv420 wire: cv2's full-range BT.601 YCrCb in 14-bit fixed point,
# chroma by a 2x2 INTER_AREA mean; decoded R = Y + 1.403 Cr', G = Y - 0.714
# Cr' - 0.344 Cb', B = Y + 1.773 Cb' with nearest chroma


def pack_yuv420(rgb: np.ndarray) -> np.ndarray:
    b, h, w, _ = rgb.shape
    c = rgb.astype(np.int32)
    r, g, bl = c[..., 0], c[..., 1], c[..., 2]
    y = (4899 * r + 9617 * g + 1868 * bl + 8192) >> 14
    bias = (128 << 14) + 8192
    cr = np.clip(((r - y) * 11682 + bias) >> 14, 0, 255)
    cb = np.clip(((bl - y) * 9241 + bias) >> 14, 0, 255)

    def area(p):
        return (p.reshape(b, h // 2, 2, w // 2, 2).sum(axis=(2, 4)) + 2) >> 2

    return np.concatenate([y.reshape(b, -1), area(cr).reshape(b, -1),
                           area(cb).reshape(b, -1)], 1).astype(np.uint8)


def decode_yuv420(packed: torch.Tensor, hw) -> torch.Tensor:
    h, w = hw
    n, q = h * w, (h // 2) * (w // 2)
    y = packed[:, :n].reshape(-1, h, w).float()

    def chroma(p):
        p = p.reshape(-1, h // 2, w // 2).float() - 128.0
        return p.repeat_interleave(2, 1).repeat_interleave(2, 2)

    cr, cb = chroma(packed[:, n:n + q]), chroma(packed[:, n + q:])
    rgb = torch.stack([y + 1.403 * cr, y - 0.714 * cr - 0.344 * cb,
                       y + 1.773 * cb], -1)
    return rgb.round().clamp(0, 255).to(torch.uint8)


# --- SLIC (CIELAB D65, regular grid, 2*step Chebyshev window, score
# p.c - |c|^2 / 2 over L, a, b, y*ratio, x*ratio, lowest id on ties, an
# empty window falls back to all centres; centres move to the mean of
# their members, L, a, b summed in 16-bit fixed point)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    rgb = rgb.clamp(0.0, 1.0)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b

    def f(t):
        return torch.where(t > 0.008856, t.pow(1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(x / 0.950456), f(y / 1.0), f(z / 1.088754)
    L = torch.where(y > 0.008856, 116.0 * fy - 16.0, 903.3 * y)
    return torch.stack([L, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)


def slic_grid(h: int, w: int, n_segments: int):
    step = (h * w / n_segments) ** 0.5
    gy = max(1, int(round(h / step)))
    gx = max(1, int(round(w / step)))
    ys = (np.arange(gy) + 0.5) * (h / gy)
    xs = (np.arange(gx) + 0.5) * (w / gx)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32), step


def _slic_assign(lab, cent, fy, fx, ratio, window, dt, chunk):
    """(B, HW) labels of planar lab (B, 3, HW) against centres (B, K, 5)."""
    b, _, hw = lab.shape
    out = torch.empty((b, hw), dtype=torch.int64, device=lab.device)
    cl, ca, cb, cy, cx = (cent[..., i] for i in range(5))
    cyr, cxr = cy * ratio, cx * ratio
    half = 0.5 * (cl * cl + ca * ca + cb * cb + cyr * cyr + cxr * cxr)
    pyr, pxr = fy * ratio, fx * ratio
    for i in range(0, b, chunk):
        s = slice(i, i + chunk)
        c = [t[s, None, :].to(dt) for t in (cl, ca, cb, cyr, cxr, half)]
        p = [lab[s, j, :, None].to(dt) for j in range(3)]
        score = (c[0] * p[0] + c[1] * p[1] + c[2] * p[2]
                 + c[3] * pyr[None, :, None].to(dt)
                 + c[4] * pxr[None, :, None].to(dt) - c[5])
        in_win = (((fy[None, :, None] - cy[s, None, :]).abs() <= window)
                  & ((fx[None, :, None] - cx[s, None, :]).abs() <= window))
        masked = torch.where(in_win, score, float("-inf"))
        out[s] = torch.where(in_win.any(-1), masked.argmax(-1),
                             score.argmax(-1))
    return out


@torch.no_grad()
def slic(images_u8: torch.Tensor, n_segments: int, compactness: float,
         n_iter: int, score_dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, H, W) int64 labels in [0, K)."""
    b, h, w, _ = images_u8.shape
    dev = images_u8.device
    f32 = torch.float32
    yx, step = slic_grid(h, w, n_segments)
    k = yx.shape[0]
    lab_img = rgb_to_lab(images_u8.to(f32) / 255.0)
    cyx = torch.from_numpy(yx).to(dev)
    iy = cyx[:, 0].long().clamp(0, h - 1)
    ix = cyx[:, 1].long().clamp(0, w - 1)
    cent = torch.cat([lab_img[:, iy, ix], cyx.expand(b, k, 2)], -1)
    lab = lab_img.permute(0, 3, 1, 2).reshape(b, 3, h * w)
    ratio = torch.tensor(((compactness / step) ** 2) ** 0.5, dtype=f32,
                         device=dev)
    window = torch.tensor(2.0 * step, dtype=f32, device=dev)
    pix = torch.arange(h * w, device=dev)
    fy, fx = (pix // w).to(f32), (pix % w).to(f32)
    chunk = max(1, (1 << 26) // (h * w * k))
    fixed = torch.round(lab.double() * 65536.0)  # (B, 3, HW)
    rows = torch.cat([fixed, fy.double().expand(b, 1, -1),
                      fx.double().expand(b, 1, -1),
                      torch.ones_like(fixed[:, :1])], 1)  # (B, 6, HW)
    for _ in range(n_iter):
        labels = _slic_assign(lab, cent, fy, fx, ratio, window, score_dtype,
                              chunk)
        sums = torch.zeros((b, k, 6), dtype=torch.float64, device=dev)
        sums.scatter_add_(1, labels[..., None].expand(-1, -1, 6),
                          rows.transpose(1, 2))
        n = sums[..., 5:]
        mean = torch.cat([sums[..., :3] / n / 65536.0, sums[..., 3:5] / n],
                         -1).to(f32)
        cent = torch.where(n > 0, mean, cent)
    return _slic_assign(lab, cent, fy, fx, ratio, window, score_dtype,
                        chunk).reshape(b, h, w)


# --- draws, align, prior, k-means, paint


def anchor_bits(num_segments: int) -> int:
    return 31 - max(1, int(num_segments - 1).bit_length())


def draws(seed: int, images: int, hw: int, num_segments: int, device):
    """(anchor keys (images, hw) int64, uniforms (images * S,)) of one
    clustering group."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bits = torch.randint(0, 2 ** anchor_bits(num_segments), (images, hw),
                         generator=gen, device=device)
    unif = torch.rand((images * num_segments,), generator=gen, device=device)
    return bits, unif


def _segment_mean(values, ids, s):
    """(B, N, C) values, (B, N) ids -> (B, S, C) float64 means (0 where
    absent), counts (B, S)."""
    b, _, c = values.shape
    sums = torch.zeros((b, s, c), dtype=torch.float64, device=values.device)
    sums.scatter_add_(1, ids[..., None].expand(-1, -1, c), values.double())
    cnt = torch.zeros((b, s), dtype=torch.float64, device=values.device)
    cnt.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float64))
    return sums / cnt.clamp(min=1)[..., None], cnt


def align(fmap, sps, keys, n_anchors, s):
    """Mean of the bilinear feature samples at up to ``n_anchors`` random
    pixels of each superpixel, then its centre of mass (y, x).

    fmap (B, hf, wf, C) float32; sps (B, H, W) int64; keys (B, H*W).
    Returns (feats (B, S, C + 2) float32, valid (B, S) bool)."""
    b, h, w = sps.shape
    hf, wf, c = fmap.shape[1:]
    ids = sps.reshape(b, -1)
    n = h * w
    order = torch.sort(ids * 2 ** anchor_bits(s) + keys, dim=1,
                       stable=True).indices
    cnt = torch.zeros((b, s), dtype=torch.int64, device=sps.device)
    cnt.scatter_add_(1, ids, torch.ones_like(ids))
    start = torch.cumsum(cnt, 1) - cnt
    offs = torch.arange(n_anchors, device=sps.device)
    pick = order.gather(1, (start[..., None] + offs).clamp(0, n - 1)
                        .reshape(b, -1)).reshape(b, s, n_anchors)
    ok = offs < cnt[..., None]
    ratio = float(hf) / float(h)
    py = (pick // w).float() * ratio + 0.5
    px = (pick % w).float() * ratio + 0.5
    py = py.clamp(0.0, hf - 1 + 0.5)
    px = px.clamp(0.0, wf - 1 + 0.5)
    y0 = torch.floor(py - 0.5).clamp(0, hf - 2).long()
    x0 = torch.floor(px - 0.5).clamp(0, wf - 2).long()
    wy1 = (py - (y0.float() + 0.5))[..., None]
    wy0 = ((y0.float() + 1.5) - py)[..., None]
    wx1 = (px - (x0.float() + 0.5))[..., None]
    wx0 = ((x0.float() + 1.5) - px)[..., None]
    flat = fmap.reshape(b, hf * wf, c)
    bi = torch.arange(b, device=fmap.device)[:, None]

    def at(yy, xx):
        return flat[bi, (yy * wf + xx).reshape(b, -1)].reshape(
            b, s, n_anchors, c)

    f = (wx0 * wy0 * at(y0, x0) + wx0 * wy1 * at(y0 + 1, x0)
         + wx1 * wy0 * at(y0, x0 + 1) + wx1 * wy1 * at(y0 + 1, x0 + 1))
    m = ok[..., None].float()
    mean = (f * m).sum(-2) / cnt.clamp(min=1).clamp(max=n_anchors)[
        ..., None].float()
    yy = (torch.arange(n, device=sps.device) // w).float()
    xx = (torch.arange(n, device=sps.device) % w).float()
    com, _ = _segment_mean(torch.stack([yy, xx], -1).expand(b, n, 2), ids, s)
    return torch.cat([mean, com.float()], -1), cnt > 0


def prior(sps, s, y_rel_pos, x_rel_pos, y_rel_sigma, x_rel_sigma):
    """(B, S) float32 mean per superpixel of the Gaussian road prior at
    (int(H * y_rel_pos), int(W * x_rel_pos)), over (2 sigma)**2."""
    b, h, w = sps.shape
    dev = sps.device
    yc = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xc = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    y_sigma, x_sigma = h * y_rel_sigma, w * x_rel_sigma
    g = torch.exp(-((yc - float(int(h * y_rel_pos))) ** 2
                    / (2.0 * y_sigma) ** 2
                    + (xc - float(int(w * x_rel_pos))) ** 2
                    / (2.0 * x_sigma) ** 2))
    vals = g.reshape(1, -1, 1).expand(b, -1, 1)
    mean, _ = _segment_mean(vals, sps.reshape(b, -1), s)
    return mean[..., 0].float()


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def kmeans(x, wgt, valid, unif, k, n_iter, tf32=False):
    """Prior-seeded weighted k-means of one group: (N,) int64 assignment,
    -1 on invalid rows.  Seeding: rows above the median prior go to
    cluster 0, the rest round-robin to 1..k-1 in the order of the
    uniforms; centres start as plain means; cluster 0 then weighs by the
    prior, the others by 1 - prior; stop on a stable assignment or an
    empty cluster."""
    n = x.shape[0]
    dev = x.device
    nv = int(valid.sum())
    thr = torch.sort(torch.where(valid, wgt, float("inf"))).values[nv // 2]
    lo = valid & (wgt <= thr)
    order = torch.argsort(torch.where(lo, unif, float("inf")), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    assign = torch.where(lo, rank % (k - 1) + 1, 0)
    assign = torch.where(valid, assign, -1)
    ks = torch.arange(k, device=dev)

    def means(a, rw):
        oh = (a[:, None] == ks).float() * rw[:, None]
        return (oh.T @ x) / oh.sum(0)[:, None]

    with _tf32(tf32):
        cent = means(assign, valid.float())
        x2 = (x * x).sum(-1, keepdim=True)
        for _ in range(n_iter):
            d2 = x2 - 2.0 * (x @ cent.T) + (cent * cent).sum(-1)[None]
            new = torch.where(valid, d2.argmin(-1), -1)
            if bool((new == assign).all()):
                break
            ew = torch.where(valid, torch.where(new == 0, wgt, 1.0 - wgt), 0.0)
            cent = means(new, ew)
            assign = new
            if bool(((new[:, None] == ks).sum(0) == 0).any()):
                break
    return assign


@torch.no_grad()
def masks(fmap, sps, seeds, cfg: dict, tf32=False) -> torch.Tensor:
    """Road masks (B, H, W) bool of a unit: its superpixel maps (B, H, W),
    its DRN features (B, hf, wf, C) and its groups' seeds, split in order
    into len(seeds) groups."""
    sp, al, km, pr = (cfg["superpixel"], cfg["align"], cfg["kmeans"],
                      cfg["prior"])
    b, h, w = sps.shape
    s = slic_grid(h, w, sp["n_slic_segments"])[0].shape[0]
    g = len(seeds)
    per = b // g
    out = []
    for i, seed in enumerate(seeds):
        rows = slice(i * per, (i + 1) * per)
        keys, unif = draws(seed, per, h * w, s, sps.device)
        feats, valid = align(fmap[rows], sps[rows], keys, al["n_anchors"], s)
        wgt = prior(sps[rows], s, pr["y_rel_pos"], pr["x_rel_pos"],
                    pr["y_rel_sigma"], pr["x_rel_sigma"])
        a = kmeans(feats.reshape(per * s, -1), wgt.reshape(-1),
                   valid.reshape(-1), unif, km["n_clusters"], km["n_iter"],
                   tf32=tf32).reshape(per, s)
        out.append(a.gather(1, sps[rows].reshape(per, -1)).reshape(
            per, h, w) == 0)
    return torch.cat(out)


def confusion(road: np.ndarray, label_ids: np.ndarray) -> tuple:
    """(TP, FP, FN) of a road mask against full-resolution labelIds:
    nearest upsampling (src = floor(dst * src_len / dst_len) in float32),
    ids 0..6 void, 7 road, the rest not road."""
    h, w = label_ids.shape
    mh, mw = road.shape
    ys = np.clip(np.floor(np.arange(h, dtype=np.float32)
                          * (np.float32(mh) / np.float32(h))), 0, mh - 1)
    xs = np.clip(np.floor(np.arange(w, dtype=np.float32)
                          * (np.float32(mw) / np.float32(w))), 0, mw - 1)
    pred = road[ys.astype(np.int64)][:, xs.astype(np.int64)]
    gt_road = label_ids == 7
    gt_other = label_ids >= 8
    return (int((pred & gt_road).sum()), int((pred & gt_other).sum()),
            int((~pred & gt_road).sum()))
