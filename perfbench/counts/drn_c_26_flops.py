"""Convolution operations of a DRN-C (Yu, Koltun & Funkhouser 2017) up to
its stage-8 output, from the published layer table in the configuration
(``channels``, ``layers``), not from the program's modules: 2 x the
multiply-adds of every convolution an image passes through, the
downsampling 1x1 convolutions included, the classifier head not."""

from __future__ import annotations


def _out(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def conv_table(model: dict, hw) -> list:
    """[(name, cin, cout, kernel, out_h, out_w)] of every convolution up to
    stage 8, for an (H, W) input."""
    ch, layers = model["channels"], model["layers"]
    h, w = hw
    rows = [("conv1", 3, ch[0], 7, h, w)]
    cin = ch[0]
    strides = (1, 2, 2, 2, 1, 1, 1, 1)
    for s, (planes, n, stride) in enumerate(zip(ch, layers, strides), 1):
        for b in range(n):
            st = stride if b == 0 else 1
            oh, ow = _out(h, st), _out(w, st)
            rows.append((f"layer{s}.{b}.conv1", cin, planes, 3, oh, ow))
            rows.append((f"layer{s}.{b}.conv2", planes, planes, 3, oh, ow))
            if b == 0 and (st != 1 or cin != planes):
                rows.append((f"layer{s}.{b}.downsample", cin, planes, 1,
                             oh, ow))
            cin, h, w = planes, oh, ow
    return rows


def flops_per_image(model: dict, hw) -> float:
    return float(sum(2 * ho * wo * ci * co * k * k
                     for _, ci, co, k, ho, wo in conv_table(model, hw)))
