"""Bilinear score resize with half-pixel centres.

Counterpart of ``spalign_tpu/ops/resize.py::bilinear_resize``
(``jax.image.resize(method="linear")``, reference
models/segnet_basic.py:105-110).  Upsampling is
``F.interpolate(mode="bilinear", align_corners=False)``; ``jax.image.resize``
antialiases when it shrinks, so a shrinking resize passes
``antialias=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, out_hw, spatial_axes=(0, 1)):
    """Half-pixel-centre bilinear resize along two axes (default leading).

    For NHWC score tensors pass spatial_axes=(1, 2); for HWC use (0, 1).
    """
    ay, ax = (a % x.dim() for a in spatial_axes)
    h, w = x.shape[ay], x.shape[ax]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    others = [d for d in range(x.dim()) if d not in (ay, ax)]
    perm = others + [ay, ax]
    xt = x.permute(perm)
    lead = xt.shape[:-2]
    y = F.interpolate(xt.reshape(1, -1, h, w), size=(oh, ow),
                      mode="bilinear", align_corners=False,
                      antialias=oh < h or ow < w)
    y = y.reshape(*lead, oh, ow)
    inv = [0] * x.dim()
    for i, d in enumerate(perm):
        inv[d] = i
    return y.permute(inv)
