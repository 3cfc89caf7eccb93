"""Plain DRN-D features (Yu, Koltun & Funkhouser, "Dilated Residual
Networks", CVPR 2017, arXiv 1705.09914), written from the published layer
table in the configuration: ``torch.nn.functional`` convolutions and
batch norms in float32 with TF32 off, NCHW, no kernel of the program.

The table, stage by stage (``layers[s]`` units of ``channels[s]``):
- stage 0: a 7x7 convolution, BN, ReLU (``layer0``);
- stages 1-2: 3x3 conv-BN-ReLU layers, stride 2 in stage 2's first;
- stages 3-6: bottleneck blocks, 1x1 -> 3x3 -> 1x1 to ``expansion`` x
  the stage's channels, the skip added before the last ReLU; a stage's
  first block takes a 1x1 convolution and BN on its skip; strides 2, 2,
  1, 1; dilation 2 in stage 5 and 4 in stage 6, the first block too (no
  new level, unlike DRN-C's first blocks);
- stages 7-8: 3x3 conv-BN-ReLU layers at dilation 2 and 1, no residual.

``features`` returns the stage-``feature_map`` output NHWC in float32 for
a (B, H, W, 3) RGB uint8 batch, with the ImageNet normalisation of the
reference's ``batch_predict`` (models/drn.py:304-321).  ``quant="fp8"``
is the control, as in ``reference/drn.py``: every convolution's input and
weight rounded to float8 e4m3 with a per-tensor scale.

Departures from the paper, all as the reference's released code has
them: the stride of a bottleneck sits on its 3x3 convolution (the paper's
ResNet puts it on the first 1x1); batch norms are the inference form, on
running statistics; the classifier (the 1x1 ``fc``) is not computed,
since the label path reads stage 8.

Weights come as a state dict of the published names
(``perfbench/weights_drn_d.py``).
"""

from __future__ import annotations

import torch

from perfbench.reference.drn import IMAGENET_MEAN, IMAGENET_STD, _bn, _conv
from perfbench.weights_drn_d import STRIDES

DILATIONS = (1, 1, 1, 1, 2, 4, 2, 1)  # of stages 1..8


def _conv_bn_relu(sd, conv, bn, x, stride, dilation, quant):
    return torch.relu(_bn(sd, bn, _conv(sd, conv, x, stride, dilation,
                                        dilation, quant)))


def _bottleneck(sd, name, x, stride, dilation, down, quant):
    y = torch.relu(_bn(sd, name + ".bn1",
                       _conv(sd, name + ".conv1", x, quant=quant)))
    y = _conv_bn_relu(sd, name + ".conv2", name + ".bn2", y, stride,
                      dilation, quant)
    y = _bn(sd, name + ".bn3", _conv(sd, name + ".conv3", y, quant=quant))
    skip = x
    if down:
        skip = _bn(sd, name + ".downsample.1",
                   _conv(sd, name + ".downsample.0", x, stride, quant=quant))
    return torch.relu(y + skip)


@torch.no_grad()
def features(sd: dict, model: dict, images_u8: torch.Tensor,
             quant=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB on the device -> (B, hf, wf, C) float32."""
    dev = images_u8.device
    x = images_u8.to(torch.float32) / 255.0
    x = (x - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(
        IMAGENET_STD, device=dev)
    x = x.permute(0, 3, 1, 2).contiguous()
    x = torch.relu(_bn(sd, "layer0.1", _conv(sd, "layer0.0", x, 1, 3, 1,
                                             quant)))
    cin, exp = model["channels"][0], model["expansion"]
    stages = zip(model["channels"], model["layers"], STRIDES, DILATIONS)
    for s, (planes, n, stride, dil) in enumerate(stages, 1):
        for b in range(n):
            st = stride if b == 0 else 1
            if s in (1, 2, 7, 8):
                x = _conv_bn_relu(sd, f"layer{s}.{3 * b}",
                                  f"layer{s}.{3 * b + 1}", x, st, dil, quant)
                cin = planes
                continue
            wide = planes * exp
            x = _bottleneck(sd, f"layer{s}.{b}", x, st, dil,
                            b == 0 and (st != 1 or cin != wide), quant)
            cin = wide
        if s == model["feature_map"] + 1:
            break
    return x.permute(0, 2, 3, 1).contiguous()
