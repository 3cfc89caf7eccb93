"""Procedural Cityscapes-like road scenes, made from a seed on the device.

The construction of the port's ``data/synthetic.py`` scene generator
(road trapezoid from a vanishing point, sidewalks, sky gradient, blocky
textured buildings with window grids, trees, a car, lane marking, void
rims, value and block noise), frozen here so that a change to the program
cannot change the benchmark's inputs, and computed with torch on the
benchmark's device so that set-up stays short.  Each scene's few scalars
and noise grids come from a ``RandomState`` seeded by
``SeedSequence([seed, index])`` (any whole number up to 2**64 is a seed),
its per-pixel noise from a ``torch.Generator`` on the device seeded the
same way.
"""

from __future__ import annotations

import numpy as np
import torch

ROAD, SIDEWALK, BUILDING, SKY, CAR, VOID = 7, 8, 11, 23, 26, 4


def _rng(seed: int, index: int) -> np.random.RandomState:
    return np.random.RandomState(
        np.random.SeedSequence([seed, index]).generate_state(4))


def _value_noise(rng, h, w, cell, amp, dev):
    gh, gw = max(2, h // cell + 2), max(2, w // cell + 2)
    grid = torch.from_numpy(rng.randn(gh, gw).astype(np.float32)).to(dev)
    ys = torch.linspace(0, gh - 1.001, h, device=dev)
    xs = torch.linspace(0, gw - 1.001, w, device=dev)
    y0, x0 = ys.long(), xs.long()
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    g = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
         + grid[y0 + 1][:, x0] * fy * (1 - fx)
         + grid[y0][:, x0 + 1] * (1 - fy) * fx
         + grid[y0 + 1][:, x0 + 1] * fy * fx)
    return amp * g


def _block_noise(rng, h, w, cell, amp, dev):
    grid = torch.from_numpy(rng.randn(h // cell + 1, w // cell + 1).astype(
        np.float32)).to(dev)
    ar_y = torch.arange(h, device=dev) // cell
    ar_x = torch.arange(w, device=dev) // cell
    return amp * grid[ar_y][:, ar_x]


def _paint(img, mask, rgb):
    """img[mask] = rgb, rgb (3,) or (H, W, 3)."""
    img.copy_(torch.where(mask[..., None], rgb, img))


@torch.no_grad()
def scene(seed: int, index: int, shape, device):
    """(RGB (H, W, 3) uint8, labelIds (H, W) uint8) device tensors."""
    rng = _rng(seed, index)
    dev = torch.device(device)
    h, w = shape
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
    yf, xf = yy / h, xx / w

    horizon = rng.uniform(0.42, 0.52)
    vp_x = rng.uniform(0.4, 0.6)
    half_width_bottom = rng.uniform(0.28, 0.45)
    t = ((yf - horizon) / (1 - horizon)).clamp(0, 1)
    road = (yf > horizon) & ((xf - vp_x).abs() < half_width_bottom * t)
    sidewalk = (yf > horizon) & ~road & (
        (xf - vp_x).abs() < (half_width_bottom + 0.08) * t)
    sky = yf < horizon * rng.uniform(0.55, 0.75)
    building = ~road & ~sidewalk & ~sky
    car = torch.zeros_like(road)
    if rng.rand() > 0.3:
        cy = rng.uniform(horizon + 0.08, 0.8)
        cx = vp_x + rng.uniform(-0.15, 0.15)
        ch_, cw_ = 0.08 * (cy - horizon) / (1 - horizon) + 0.02, 0.05
        car = ((yf - cy).abs() < ch_) & ((xf - cx).abs() < cw_) & road

    labels = torch.full((h, w), BUILDING, dtype=torch.uint8, device=dev)
    for mask, lid in ((sky, SKY), (sidewalk, SIDEWALK), (road, ROAD),
                      (car, CAR)):
        labels[mask] = lid
    rim = 6
    labels[:rim], labels[-rim:] = VOID, VOID
    labels[:, :rim], labels[:, -rim:] = VOID, VOID

    img = torch.zeros((h, w, 3), device=dev)
    _paint(img, sky, torch.stack([100 + 40 * yf, 140 + 40 * yf,
                                  200 + 30 * yf], -1))
    by, bx = rng.randint(40, 90), rng.randint(30, 80)
    blocks = ((yy // by) * 7 + (xx // bx) * 13).long() % 5
    bcol = torch.tensor([[120, 110, 100], [150, 140, 130], [100, 95, 90],
                         [170, 160, 150], [90, 80, 75]], dtype=torch.float32,
                        device=dev)
    _paint(img, building, bcol[blocks])
    shade = 80 + 30 * t + 8 * torch.sin(xx / 17.0)
    _paint(img, road, shade[..., None].expand(h, w, 3))
    lane = road & ((xf - vp_x).abs() < 0.004 * (1 + 3 * t))
    _paint(img, lane, torch.tensor([200.0, 200.0, 190.0], device=dev))
    _paint(img, sidewalk, (150 + 10 * torch.cos(xx / 9.0))[..., None]
           .expand(h, w, 3))
    _paint(img, car, torch.tensor([rng.uniform(60, 220) for _ in range(3)],
                                  dtype=torch.float32, device=dev))
    tex = (_block_noise(rng, h, w, 96, 14.0, dev)
           + _block_noise(rng, h, w, 48, 10.0, dev)
           + _value_noise(rng, h, w, 160, 10.0, dev))
    amp = (building * 1.6 + sidewalk * 0.9 + road * 0.7 + sky * 0.35)
    img += (tex * amp)[..., None]
    wy, wx = rng.randint(28, 52), rng.randint(20, 44)
    windows = ((yy % wy < wy * 0.45) & (xx % wx < wx * 0.45) & building
               & (yf > 0.1))
    img[windows] *= 0.28
    for _ in range(rng.randint(2, 5)):
        ty = rng.uniform(horizon - 0.12, horizon + 0.02)
        tx = rng.uniform(0.05, 0.95)
        tr = rng.uniform(0.03, 0.09)
        tree = ((yf - ty) ** 2 + (xf - tx) ** 2 < tr ** 2) & ~road
        _paint(img, tree, torch.tensor(
            np.array([45, 70, 35], np.float32)
            + 12 * rng.randn(3).astype(np.float32), device=dev))
    img[..., 0] += _value_noise(rng, h, w, 120, 9.0, dev)
    img[..., 2] += _value_noise(rng, h, w, 90, 9.0, dev)
    gen = torch.Generator(device=dev).manual_seed(
        int(np.random.SeedSequence([seed, index, 1]).generate_state(1)[0]))
    img += torch.randn((h, w, 3), generator=gen, device=dev) * 4.0
    return img.clamp(0, 255).to(torch.uint8), labels


def render(seed: int, n: int, shape=(1024, 2048), device="cpu"):
    """(frames (n, H, W, 3) uint8, labelIds (n, H, W) uint8) on the host,
    made on ``device``."""
    frames = np.empty((n, *shape, 3), np.uint8)
    labels = np.empty((n, *shape), np.uint8)
    for i in range(n):
        im, lab = scene(seed, i, shape, device)
        frames[i] = im.cpu().numpy()
        labels[i] = lab.cpu().numpy()
    return frames, labels
