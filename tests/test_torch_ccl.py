"""The port's device CCL (spalign_tpu_torch/kernels/experimental/ccl.py,
plain torch) against the JAX package's ``enforce_connectivity_device``
(jnp) on the CPU: the cases of tests/test_ccl_device.py and random maps
with min_size 1 and above, and a component count past ``max_components``
(JAX drops those ids in its segment reductions and clamps its gathers).
Tolerance: none, the maps are equal (integer arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.kernels.experimental.ccl import (
    enforce_connectivity_device as jax_ccl)
from spalign_tpu_torch import native
from spalign_tpu_torch.kernels.experimental.ccl import (
    enforce_connectivity_device)


def _island():
    lab = np.zeros((12, 12), np.int32)
    lab[:, 8:] = 1
    lab[5:7, 2:4] = 1  # an island with the right strip's id
    return lab


def _dot():
    lab = np.zeros((12, 12), np.int32)
    lab[5, 5] = 1
    return lab


def _chain():
    lab = np.zeros((8, 16), np.int32)
    lab[4, 4], lab[4, 5], lab[4, 6] = 1, 2, 3
    return lab


def _random(shape, n_labels, seed):
    return np.random.RandomState(seed).randint(
        0, n_labels, size=shape).astype(np.int32)


CASES = {
    # tests/test_ccl_device.py
    "splits_disconnected": (_island(), dict(min_size=1)),
    "absorbs_small": (_dot(), dict(min_size=4)),
    "chain_of_fragments": (_chain(), dict(min_size=3)),
    "random_24x32": (_random((24, 32), 5, 0), dict(min_size=1, n_iter=24)),
    "batch_min_size_6": (_random((2, 16, 16), 4, 1),
                         dict(min_size=6, n_iter=24)),
    # random maps, min_size 1 and above, default statics
    "random_min1": (_random((3, 40, 56), 6, 2), dict(min_size=1)),
    "random_min3": (_random((3, 40, 56), 6, 3), dict(min_size=3)),
    "random_min8_few_sweeps": (_random((2, 48, 48), 3, 4),
                               dict(min_size=8, n_iter=4, n_absorb=2)),
    # more components than max_components
    "past_max_components": (_random((1, 64, 64), 3, 5),
                            dict(min_size=4, n_iter=4, max_components=64)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_equals_jax(name):
    lab, kw = CASES[name]
    got = enforce_connectivity_device(torch.from_numpy(lab), **kw)
    want = np.asarray(jax_ccl(jnp.asarray(lab), **kw))
    assert got.dtype == torch.int32 and got.shape == lab.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _partition_equal(a, b):
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return len(pairs) == len({p[0] for p in pairs}) == len(
        {p[1] for p in pairs})


def test_min_size_1_is_the_host_partition():
    """Before absorption the components are the host op's, up to ids."""
    for seed in range(3):
        lab = _random((24, 32), 5, 10 + seed)
        got = enforce_connectivity_device(torch.from_numpy(lab),
                                          n_iter=24).numpy()
        ref = native.enforce_connectivity(lab, min_size=1)
        assert _partition_equal(got, ref)
        assert got.max() == ref.max()
        assert got[0, 0] == 0  # ids by first raster occurrence
