"""Inputs and weights are functions of the seed, for any whole number up
to 2**64."""

import numpy as np
import torch

from perfbench import harness, scenes, weights


def test_scenes_by_seed():
    big = 2 ** 33 + 7
    a = scenes.render(big, 2, (64, 128))
    b = scenes.render(big, 2, (64, 128))
    c = scenes.render(big + 1, 2, (64, 128))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.uint8 and a[0].shape == (2, 64, 128, 3)
    assert (a[1] == 7).any()  # every scene has road


def test_weights_by_seed():
    model = {"width": 8, "kernel": 3, "levels": 2, "n_class": 2}
    shapes = weights.segnet_shapes(model)
    a = weights.make(shapes, 5, "cpu", 2 ** 0.5)
    b = weights.make(shapes, 5, "cpu", 2 ** 0.5)
    c = weights.make(shapes, 6, "cpu", 2 ** 0.5)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    assert a["conv1_bn.running_var"].min() >= 1.0


def test_derived_seeds():
    s = harness.seeds(2 ** 40 + 3, 4)
    assert s == harness.seeds(2 ** 40 + 3, 4)
    assert len(set(s)) == 4 and all(0 <= x < 2 ** 31 for x in s)
