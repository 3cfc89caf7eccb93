"""Procedural Cityscapes-like road scenes for tests and benchmarks.

No Cityscapes data ships with the repository, so the package carries a
deterministic scene generator producing (image, labelIds) pairs with the
same conventions as the real dataset: full resolution 1024x2048 RGB, road
= labelId 7 occupying a bottom trapezoid, void rims (labelId 0..6), sky /
buildings / sidewalk with distinct textures.  Scenes are seeded, so tests
and benchmarks are reproducible.

The port's own copy of ``spalign_tpu/data/synthetic.py``: the scenes
are the same arrays; ``resized_batch`` resizes with the host library's
copy of cv2's cubic filter (``native.resize_cubic_u8``) instead of cv2,
which the port does not use.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spalign_tpu_torch import native


def _value_noise(rng, h, w, cell, amp):
    """Bilinearly-upsampled random grid: medium-frequency texture that
    survives cubic downsampling to 224x224 (so felzenszwalb finds a
    realistic ~10^2 superpixel count, as on real street imagery)."""
    gh, gw = max(2, h // cell + 2), max(2, w // cell + 2)
    grid = rng.randn(gh, gw).astype(np.float32)
    ys = np.linspace(0, gh - 1.001, h)
    xs = np.linspace(0, gw - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    g = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
         + grid[y0 + 1][:, x0] * fy * (1 - fx)
         + grid[y0][:, x0 + 1] * (1 - fy) * fx
         + grid[y0 + 1][:, x0 + 1] * fy * fx)
    return amp * g


def _block_noise(rng, h, w, cell, amp):
    """Nearest-upsampled random mosaic: SHARP patch boundaries (windows,
    bricks, asphalt patches) that felzenszwalb-style algorithms segment
    the way they segment real street texture."""
    gh, gw = h // cell + 1, w // cell + 1
    grid = rng.randn(gh, gw).astype(np.float32)
    return amp * grid[np.arange(h) // cell][:, np.arange(w) // cell]


def _texture(rng, h, w, octaves=((96, 14.0), (48, 10.0)),
             smooth=((160, 10.0),)):
    t = np.zeros((h, w), np.float32)
    for cell, amp in octaves:
        t += _block_noise(rng, h, w, cell, amp)
    for cell, amp in smooth:
        t += _value_noise(rng, h, w, cell, amp)
    return t


class SyntheticRoadScenes:
    """Dataset-like generator: scenes[i] -> (img_hwc uint8, label_ids uint8).

    Mirrors the get_example protocol of the reference dataset classes
    (datasets/*.py) so pipelines can consume either interchangeably.
    """

    # Cityscapes-like ids
    ROAD, SIDEWALK, BUILDING, SKY, CAR, VOID = 7, 8, 11, 23, 26, 4

    def __init__(self, n: int = 30, full_shape=(1024, 2048), seed: int = 0):
        self.n = n
        self.full_shape = tuple(full_shape)
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.n))]
        if i < 0 or i >= self.n:
            raise IndexError(i)
        return self._make(i)

    def image_name(self, i):
        return f"synthetic_{self.seed:03d}_{i:06d}_leftImg8bit.png"

    def label_name(self, i):
        return f"synthetic_{self.seed:03d}_{i:06d}_gtFine_labelIds.png"

    def _make(self, i):
        rng = np.random.RandomState(self.seed * 100003 + i)
        h, w = self.full_shape
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        yf, xf = yy / h, xx / w

        horizon = rng.uniform(0.42, 0.52)
        vp_x = rng.uniform(0.4, 0.6)  # vanishing point
        half_width_bottom = rng.uniform(0.28, 0.45)

        # Road: trapezoid from the vanishing point down.
        t = np.clip((yf - horizon) / (1 - horizon), 0, 1)
        road = (yf > horizon) & (np.abs(xf - vp_x) < half_width_bottom * t)

        # Sidewalk strips flanking the road.
        sidewalk = (yf > horizon) & ~road & (
            np.abs(xf - vp_x) < (half_width_bottom + 0.08) * t)

        sky = yf < horizon * rng.uniform(0.55, 0.75)
        building = ~road & ~sidewalk & ~sky

        # A car-ish box on the road.
        car = np.zeros_like(road)
        if rng.rand() > 0.3:
            cy = rng.uniform(horizon + 0.08, 0.8)
            cx = vp_x + rng.uniform(-0.15, 0.15)
            ch_, cw_ = 0.08 * (cy - horizon) / (1 - horizon) + 0.02, 0.05
            car = (np.abs(yf - cy) < ch_) & (np.abs(xf - cx) < cw_) & road

        labels = np.full((h, w), self.BUILDING, dtype=np.uint8)
        labels[sky] = self.SKY
        labels[sidewalk] = self.SIDEWALK
        labels[road] = self.ROAD
        labels[car] = self.CAR
        # thin void rim at image border (Cityscapes rectification artifacts)
        rim = 6
        labels[:rim], labels[-rim:] = self.VOID, self.VOID
        labels[:, :rim], labels[:, -rim:] = self.VOID, self.VOID

        img = np.zeros((h, w, 3), np.float32)
        # sky: blue gradient
        img[sky] = np.stack([100 + 40 * yf[sky], 140 + 40 * yf[sky],
                             200 + 30 * yf[sky]], axis=-1)
        # buildings: blocky grey/brown texture
        blocks = ((yy // rng.randint(40, 90)) * 7
                  + (xx // rng.randint(30, 80)) * 13) % 5
        bcol = np.array([[120, 110, 100], [150, 140, 130], [100, 95, 90],
                         [170, 160, 150], [90, 80, 75]], np.float32)
        img[building] = bcol[blocks[building]]
        # road: dark asphalt with brightness falloff + lane noise
        shade = 80 + 30 * t + 8 * np.sin(xx / 17.0)
        img[road] = np.stack([shade[road]] * 3, axis=-1)
        # lane marking
        lane = road & (np.abs(xf - vp_x) < 0.004 * (1 + 3 * t))
        img[lane] = np.array([200, 200, 190], np.float32)
        # sidewalk: lighter grey
        img[sidewalk] = np.stack([150 + 10 * np.cos(xx[sidewalk] / 9.0)] * 3,
                                 axis=-1)
        img[car] = np.array(
            [rng.uniform(60, 220), rng.uniform(60, 220),
             rng.uniform(60, 220)], np.float32)

        # Region-dependent medium-frequency texture: real street scenes
        # keep superpixel algorithms busy even after downsampling.
        tex = _texture(rng, h, w)
        img[building] += (tex[building] * 1.6)[..., None]
        img[sidewalk] += (tex[sidewalk] * 0.9)[..., None]
        img[road] += (tex[road] * 0.7)[..., None]
        img[sky] += (tex[sky] * 0.35)[..., None]

        # High-contrast structure (dark window grids, tree crowns): the
        # strong edges that stop graph-merge superpixel algorithms at
        # canonical scales, as facades/vegetation do in real imagery.
        wy = rng.randint(28, 52)
        wx = rng.randint(20, 44)
        windows = ((yy % wy < wy * 0.45) & (xx % wx < wx * 0.45)
                   & building & (yf > 0.1))
        img[windows] *= 0.28
        for _ in range(rng.randint(2, 5)):
            ty = rng.uniform(horizon - 0.12, horizon + 0.02)
            tx = rng.uniform(0.05, 0.95)
            tr = rng.uniform(0.03, 0.09)
            tree = ((yf - ty) ** 2 + (xf - tx) ** 2 < tr ** 2) & ~road
            img[tree] = (np.array([45, 70, 35], np.float32)
                         + 12 * rng.randn(3).astype(np.float32))
        # mild chroma variation so segments differ in color too
        img[..., 0] += _value_noise(rng, h, w, 120, 9.0)
        img[..., 2] += _value_noise(rng, h, w, 90, 9.0)
        img += rng.randn(h, w, 3) * 4.0
        return np.clip(img, 0, 255).astype(np.uint8), labels

    def resized_batch(self, indices, resize_hw):
        """(B, h, w, 3) uint8 images + full-res (B, H, W) labelIds; the
        images resized as cv2.INTER_CUBIC does (``native.resize_cubic_u8``)."""
        items = [self[i] for i in indices]
        imgs = np.stack([img for img, _ in items])
        return (native.resize_cubic_u8(imgs, resize_hw),
                np.stack([lab for _, lab in items]))


def _bicubic(img: np.ndarray, out_hw) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)
    y = F.interpolate(x[None].to(torch.float32), size=tuple(out_hw),
                      mode="bicubic", align_corners=False)
    return y[0].permute(1, 2, 0)


def resize_bicubic_f32(img: np.ndarray, out_hw) -> np.ndarray:
    """(H, W, C) -> (h, w, C) float32 bicubic resize on the CPU, neither
    rounded nor clamped (cv2.INTER_CUBIC on float images)."""
    return np.ascontiguousarray(_bicubic(img, out_hw).numpy())
