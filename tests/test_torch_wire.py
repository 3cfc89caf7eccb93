"""The port's yuv420 wire (spalign_tpu_torch/pipeline/wire.py) against
the JAX package's codec and cv2.

Tolerance: none — both directions are integer-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu.pipeline import wire as jwire
from spalign_tpu_torch.pipeline import wire as twire

torch.set_num_threads(2)


@pytest.mark.parametrize("hw", [(64, 96), (112, 112)])
def test_decode_bit_exact_vs_jax(hw):
    rng = np.random.RandomState(3)
    n = twire.yuv420_bytes_per_image(hw)
    packed = rng.randint(0, 256, (3, n)).astype(np.uint8)
    want = np.asarray(jwire.decode_yuv420(jnp.asarray(packed), hw))
    got = twire.decode_yuv420(torch.from_numpy(packed), hw).numpy()
    np.testing.assert_array_equal(got, want)


def test_pack_bit_exact_vs_cv2():
    pytest.importorskip("cv2")
    rng = np.random.RandomState(5)
    imgs = rng.randint(0, 256, (4, 64, 96, 3)).astype(np.uint8)
    np.testing.assert_array_equal(twire.pack_yuv420(imgs),
                                  jwire.pack_yuv420(imgs))


def test_roundtrip_on_scenes_matches_jax():
    """pack (numpy) + decode (torch) == pack (cv2) + decode (JAX)."""
    pytest.importorskip("cv2")
    imgs, _ = SyntheticRoadScenes(n=2, full_shape=(128, 256),
                                  seed=4).resized_batch(range(2), (64, 64))
    want = np.asarray(jwire.decode_yuv420(
        jnp.asarray(jwire.pack_yuv420(imgs)), (64, 64)))
    got = twire.decode_yuv420(torch.from_numpy(twire.pack_yuv420(imgs)),
                              (64, 64)).numpy()
    np.testing.assert_array_equal(got, want)


def test_odd_shape_rejected():
    with pytest.raises(ValueError):
        twire.yuv420_bytes_per_image((63, 64))


@pytest.mark.parametrize("shape", [(1, 2, 2), (3, 64, 96), (7, 30, 46),
                                   (1, 1024, 2048)])
def test_native_pack_equals_plain(shape):
    """The host library's pack (threaded over images) is bit-equal to the
    numpy pack, for odd batch sizes and a full Cityscapes frame."""
    from spalign_tpu_torch import native

    rng = np.random.RandomState(sum(shape))
    imgs = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(native.pack_yuv420(imgs),
                                  twire.pack_yuv420(imgs))


def test_native_pack_rejects_odd_shape():
    from spalign_tpu_torch import native

    with pytest.raises(ValueError):
        native.pack_yuv420(np.zeros((2, 63, 64, 3), np.uint8))
