"""Seeded weights, made on the device in a few large draws, under the
published parameter names of each configuration's layer table.  Both the
program and the plain reference take the same dict.

Convolutions are normal with std gain / sqrt(fan_in) (1 for DRN, He's 2
for SegNet); batch norms draw their scale around 1, their shift and
running mean around 0 and their running variance around 1, so that no
normalisation is the identity.
"""

from __future__ import annotations

import math

import torch


def drn_shapes(model: dict) -> list:
    """[(name, shape, fan_in or None for a BN group)] of a DRN-C with the
    configuration's ``channels``, ``layers`` and ``num_classes``."""
    ch, layers = model["channels"], model["layers"]
    out = [("conv1", (ch[0], 3, 7, 7)), ("bn1", ch[0])]
    cin = ch[0]
    strides = (1, 2, 2, 2, 1, 1, 1, 1)
    for s, (planes, n, stride) in enumerate(zip(ch, layers, strides), 1):
        for b in range(n):
            p = f"layer{s}.{b}"
            out += [(p + ".conv1", (planes, cin, 3, 3)), (p + ".bn1", planes),
                     (p + ".conv2", (planes, planes, 3, 3)),
                     (p + ".bn2", planes)]
            if b == 0 and (stride != 1 or cin != planes):
                out += [(p + ".downsample.0", (planes, cin, 1, 1)),
                        (p + ".downsample.1", planes)]
            cin = planes
    out.append(("fc", (model["num_classes"], cin, 1, 1)))
    return out


def segnet_shapes(model: dict) -> list:
    c, k = model["width"], model["kernel"]
    out = []
    for i in range(1, model["levels"] + 1):
        out += [(f"conv{i}", (c, 3 if i == 1 else c, k, k)),
                (f"conv{i}_bn", c), (f"conv_decode{i}", (c, c, k, k)),
                (f"conv_decode{i}_bn", c)]
    out.append(("conv_classifier", (model["n_class"], c, 1, 1)))
    return out


# the convolutions with a bias (zero): the DRN's head, SegNet's classifier
BIASED = ("fc", "conv_classifier")


def make(shapes: list, seed: int, device, gain: float) -> dict:
    """The state dict of ``shapes``: one normal draw for all convolution
    weights, one for all batch-norm parameters."""
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = [(n, s) for n, s in shapes if isinstance(s, tuple)]
    bns = [(n, c) for n, c in shapes if not isinstance(c, tuple)]
    flat = torch.randn(sum(math.prod(s) for _, s in convs), generator=gen,
                       device=device)
    sd, o = {}, 0
    for name, shape in convs:
        n = math.prod(shape)
        fan_in = shape[1] * shape[2] * shape[3]
        sd[name + ".weight"] = (flat[o:o + n].view(shape)
                                * (gain / math.sqrt(fan_in)))
        o += n
        if name in BIASED:
            sd[name + ".bias"] = torch.zeros(shape[0], device=device)
    norm = torch.randn(4, sum(c for _, c in bns), generator=gen,
                       device=device) * 0.1
    o = 0
    for name, c in bns:
        w, b, m, v = norm[:, o:o + c]
        sd[name + ".weight"] = 1.0 + w
        sd[name + ".bias"] = b
        sd[name + ".running_mean"] = m
        sd[name + ".running_var"] = 1.0 + v.abs()
        sd[name + ".num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64, device=device)
        o += c
    return {k: v.contiguous() for k, v in sd.items()}
