"""Plain DRN-C features (Yu, Koltun & Funkhouser 2017), written from the
configuration's layer table: ``torch.nn.functional`` convolutions and
batch norms in float32 with TF32 off, NCHW, no kernel of the program.

``features`` returns the stage-``feature_map`` output NHWC in float32 for
a (B, H, W, 3) RGB uint8 batch, with the ImageNet normalisation the
reference applies (models/drn.py:304-321).  ``quant="fp8"`` is the
control: every convolution's input and weight rounded to float8 e4m3
with a per-tensor scale (amax / 448), the product then taken in float32.

Weights come as a state dict of the published names
(``layer3.0.conv1.weight``, ``layer3.0.downsample.1.running_var``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _conv(sd, name, x, stride=1, padding=0, dilation=1, quant=None):
    w = sd[name + ".weight"].float()
    if quant == "fp8":
        x, w = _fp8(x), _fp8(w)
    return F.conv2d(x, w, None, stride, padding, dilation)


def _bn(sd, name, x):
    mean, var = sd[name + ".running_mean"], sd[name + ".running_var"]
    scale = sd[name + ".weight"] / torch.sqrt(var + BN_EPS)
    shift = sd[name + ".bias"] - mean * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _block(sd, name, x, stride, dilation, residual, has_down, quant):
    y = _conv(sd, name + ".conv1", x, stride, dilation[0], dilation[0],
              quant)
    y = torch.relu(_bn(sd, name + ".bn1", y))
    y = _bn(sd, name + ".bn2", _conv(sd, name + ".conv2", y, 1, dilation[1],
                                     dilation[1], quant))
    if residual:
        skip = x
        if has_down:
            skip = _bn(sd, name + ".downsample.1",
                       _conv(sd, name + ".downsample.0", x, stride, 0, 1,
                             quant))
        y = y + skip
    return torch.relu(y)


# DRN-C: stride, dilation, whether the first block's first conv takes half
# the dilation (a new level), and residual, of stages 1..8
_STAGES = ((1, 1, True, True), (2, 1, True, True), (2, 1, True, True),
           (2, 1, True, True), (1, 2, False, True), (1, 4, False, True),
           (1, 2, False, False), (1, 1, False, False))


@torch.no_grad()
def features(sd: dict, model: dict, images_u8: torch.Tensor,
             quant=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB on the device -> (B, hf, wf, C) float32."""
    dev = images_u8.device
    x = images_u8.to(torch.float32) / 255.0
    x = (x - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(
        IMAGENET_STD, device=dev)
    x = x.permute(0, 3, 1, 2).contiguous()
    x = torch.relu(_bn(sd, "bn1", _conv(sd, "conv1", x, 1, 3, 1, quant)))
    cin = model["channels"][0]
    last = model["feature_map"] + 1
    for s, ((stride, dil, new_level, residual), planes, n) in enumerate(
            zip(_STAGES, model["channels"], model["layers"]), 1):
        for b in range(n):
            st = stride if b == 0 else 1
            if dil == 1:
                d = (1, 1)
            elif b == 0:
                d = (dil // 2 if new_level else dil, dil)
            else:
                d = (dil, dil)
            down = b == 0 and (st != 1 or cin != planes)
            x = _block(sd, f"layer{s}.{b}", x, st, d, residual, down, quant)
            cin = planes
        if s == last:
            break
    return x.permute(0, 2, 3, 1).contiguous()
