"""Resize ops: bilinear score resize with half-pixel centres, and the
nearest-neighbour mask resize of cv2.

Counterpart of ``spalign_tpu/ops/resize.py``.  ``bilinear_resize`` is
``jax.image.resize(method="linear")`` (reference
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


def nn_resize_cv2(x: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2.INTER_NEAREST-compatible resize of the last two dims (counterpart
    of ``spalign_tpu/ops/resize.py::nn_resize_cv2``): src = floor(dst *
    (in / out)) in float32, the ratio rounded to float32 once, clipped to
    the input.  x: (..., H, W) of any dtype; bit-exact with JAX."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = int(out_hw[0]), int(out_hw[1])

    def src(n_out, n_in):
        scale = torch.tensor(n_in / n_out, dtype=torch.float32)
        idx = torch.floor(torch.arange(n_out, dtype=torch.float32) * scale)
        return idx.to(torch.int64).clamp(0, n_in - 1).to(x.device)

    return x.index_select(-2, src(oh, h)).index_select(-1, src(ow, w))
