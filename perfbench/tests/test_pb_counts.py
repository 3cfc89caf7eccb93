"""The FLOP and byte counts: against hand-worked values at the cells'
sizes, and against forward hooks on the program's models at a tiny
size (the counts themselves read only the layer tables)."""

import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.counts import (drn_c_26_flops, lloyd_bound, pool_bytes,
                              segnet_basic_flops)


def _config(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


def _hook_flops(model, run):
    seen = []

    def hook(mod, _inp, out):
        n, _, ho, wo = out.shape
        co, ci, kh, kw = mod.weight.shape
        seen.append(2 * n * ho * wo * co * ci * kh * kw)

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hs:
            h.remove()
    return sum(seen)


def test_drn_hand_worked():
    model = _config("drn26-spalign-slic")["model"]
    table = drn_c_26_flops.conv_table(model, (224, 224))
    assert table[0] == ("conv1", 3, 16, 7, 224, 224)
    # 2 * 224^2 * 3 * 16 * 7^2 for the stem; 512->512 3x3 at 28^2 for
    # each of the last stages' convolutions
    assert 2 * 224 * 224 * 3 * 16 * 49 == 236_027_904
    assert ("layer8.0.conv2", 512, 512, 3, 28, 28) in table
    assert drn_c_26_flops.flops_per_image(model, (224, 224)) == \
        33_941_454_848


@pytest.mark.parametrize("hw", [(64, 64), (56, 72)])
def test_drn_against_hooks(hw):
    from spalign_tpu_torch.models.drn import drn_c_26, preprocess_imagenet

    model = _config("drn26-spalign-slic")["model"]
    net = drn_c_26(device="cpu")
    x = preprocess_imagenet(torch.zeros(2, *hw, 3))
    hooked = _hook_flops(net, lambda: net.features(x, (7,)))
    assert hooked == 2 * drn_c_26_flops.flops_per_image(model, hw)


def test_segnet_hand_worked():
    model = _config("segnet-basic")["model"]
    fwd = 0
    for lvl, (h, w) in enumerate([(512, 1024), (256, 512), (128, 256),
                                  (64, 128)]):
        cin = 3 if lvl == 0 else 64
        fwd += 2 * 8 * h * w * 49 * 64 * (cin + 64)
    fwd += 2 * 8 * 512 * 1024 * 64 * 2
    assert segnet_basic_flops.forward_flops(model, 8, (512, 1024)) == fwd
    assert segnet_basic_flops.step_flops(model, 8, (512, 1024)) == \
        8_605_503_848_448


def test_segnet_against_hooks():
    from spalign_tpu_torch.models.segnet import build_segnet

    model = _config("segnet-basic")["model"]
    net = build_segnet("basic", 2, device="cpu")
    x = torch.zeros(2, 32, 64, 3)
    assert _hook_flops(net, lambda: net(x)) == \
        segnet_basic_flops.forward_flops(model, 2, (32, 64))


def test_pool_bytes_hand_worked():
    model = _config("segnet-basic")["model"]
    b = pool_bytes.level_bytes(8, 512, 1024, 64)
    big, small = 8 * 512 * 1024 * 64, 8 * 256 * 512 * 64
    assert b["pool"] == 4 * big + 4 * small + small
    assert b["scatter"] == 4 * small + small + 4 * big
    assert b["gather"] == 4 * big + small + 4 * small
    # four families' worth at each level, the levels a quarter each
    assert pool_bytes.step_bytes(model, 8, (512, 1024)) == \
        4 * b["pool"] * (1 + 1 / 4 + 1 / 16 + 1 / 64)


def test_lloyd_window_pairs_brute_force():
    h, w, k = 40, 56, 20
    cy, cx, step = lloyd_bound.grid(h, w, k)
    win = np.float32(2.0 * step)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    brute = sum(int(((np.abs(yy - y) <= win) & (np.abs(xx - x) <= win)).sum())
                for y, x in zip(cy, cx))
    assert lloyd_bound.window_pairs(h, w, k) == brute
    t, by = lloyd_bound.bound_s(150, 224, 224, 100, 10)
    assert by == "operations" and t == pytest.approx(1.6632830597e-4)
