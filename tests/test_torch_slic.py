"""The port's SLIC (spalign_tpu_torch/kernels) against the JAX package.

The plain version of the Lloyd kernel (``slic_lloyd_reference``, what
the wrapper runs for CPU tensors) is held to the JAX fused Pallas
kernel (interpret mode) and to the XLA dense sweep at > 0.995 label
agreement, the bar of tests/test_slic_pallas.py: the three differ only
in float association (and the dense sweep in its own-cell fallback)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu.kernels.slic_fused import (pack_centers_fused,
                                            pack_pixels_fused,
                                            slic_lloyd_fused)
from spalign_tpu_torch.kernels import slic as tslic_mod
from spalign_tpu_torch.kernels.slic_fused import (slic_lloyd,
                                                  slic_lloyd_reference)

# the package's kernels/__init__ re-exports the function ``slic``, which
# shadows the module of the same name
jslic_mod = importlib.import_module("spalign_tpu.kernels.slic")
torch.set_num_threads(2)


def test_rgb_to_lab_matches_jax():
    rgb = np.random.RandomState(0).rand(4096, 3).astype(np.float32)
    rgb[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
               [0, 1, 0], [0, 0, 1], [0.01, 0.02, 0.03], [0.04, 0.9, 0.3]]
    want = np.asarray(jslic_mod.rgb_to_lab(jnp.asarray(rgb)))
    got = tslic_mod.rgb_to_lab(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("h,w,n", [(224, 224, 100), (112, 112, 40),
                                   (96, 128, 40), (48, 56, 12),
                                   (128, 128, 30), (1024, 2048, 1024),
                                   (112, 224, 100), (7, 300, 5)])
def test_grid_size_equal(h, w, n):
    assert tslic_mod.slic_grid_size(h, w, n) == jslic_mod.slic_grid_size(
        h, w, n)
    c_t, step_t, gy_t, gx_t = tslic_mod._init_centers(h, w, n)
    c_j, step_j, gy_j, gx_j = jslic_mod._init_centers(h, w, n)
    np.testing.assert_array_equal(c_t, c_j)
    assert (step_t, gy_t, gx_t) == (step_j, gy_j, gx_j)


def _jax_fused(img, n_seg, n_iter, comp=10.0):
    """tests/test_slic_pallas.py TestFusedLloyd._run: the Pallas kernel
    in interpret mode."""
    h, w, _ = img.shape
    lab = jslic_mod.rgb_to_lab(jnp.asarray(img / 255.0))
    centers_np, step = jslic_mod._init_centers(h, w, n_seg)[:2]
    k = centers_np.shape[0]
    cy = jnp.asarray(centers_np[:, 0])
    cx = jnp.asarray(centers_np[:, 1])
    c_lab = lab[jnp.clip(cy.astype(jnp.int32), 0, h - 1),
                jnp.clip(cx.astype(jnp.int32), 0, w - 1)]
    ratio = comp / step
    out = slic_lloyd_fused(pack_pixels_fused(lab, ratio),
                           pack_centers_fused(c_lab, cy, cx, ratio),
                           k_real=k, window=float(2 * step), n_iter=n_iter,
                           interpret=True)
    return np.asarray(out)[: h * w].reshape(h, w), k


def _port(imgs, n_seg, n_iter):
    return tslic_mod.slic(imgs, n_segments=n_seg, n_iter=n_iter,
                          device="cpu").numpy()


def test_matches_jax_fused_kernel_and_dense_sweep():
    """tests/test_slic_pallas.py::TestFusedLloyd::test_matches_xla_loop
    inputs: a 96x128 synthetic scene, 40 segments, 4 sweeps."""
    img, _ = SyntheticRoadScenes(n=1, full_shape=(96, 128), seed=5)[0]
    img = img.astype(np.float32)
    got = _port(img[None], 40, 4)[0]
    fused, k = _jax_fused(img, 40, 4)
    dense = np.asarray(jslic_mod.slic(jnp.asarray(img), n_segments=40,
                                      n_iter=4, use_fused=False))
    assert (got == fused).mean() > 0.995
    assert (got == dense).mean() > 0.995
    assert got.min() >= 0 and got.max() < k


def test_random_image_matches_jax_and_is_balanced(rng):
    """The padding-pollution inputs of tests/test_slic_pallas.py (128x128
    random, 30 segments, 3 sweeps, and its first 96 rows): agreement with
    JAX and the structural checks (every id used, no id over half the
    image)."""
    img = rng.randint(0, 255, (128, 128, 3)).astype(np.float32)
    for im in (img, img[:96]):
        got = _port(im[None], 30, 3)[0]
        fused, k = _jax_fused(im, 30, 3)
        assert (got == fused).mean() > 0.995
        sizes = np.bincount(got.ravel(), minlength=k)
        assert (sizes > 0).all()
        assert sizes.max() < got.size * 0.5


def test_images_of_a_batch_do_not_interact(rng):
    """The port packs no padding; the batched loop must still keep each
    image's centres to its own pixels: a batch equals each image alone."""
    imgs = rng.randint(0, 255, (3, 48, 56, 3)).astype(np.float32)
    together = _port(imgs, 12, 3)
    for i in range(3):
        np.testing.assert_array_equal(together[i], _port(imgs[i:i + 1],
                                                         12, 3)[0])
    assert together.min() >= 0
    assert together.max() < tslic_mod.slic_grid_size(48, 56, 12)


def test_empty_window_takes_unmasked_argmax():
    """A centre parked far away with every window empty: pixels fall back
    to the unmasked argmax, never to -1."""
    lab = torch.zeros((1, 3, 16), dtype=torch.float32)
    c0 = torch.tensor([[[0.0, 0.0, 0.0, 100.0, 100.0],
                        [5.0, 0.0, 0.0, 200.0, 200.0]]])
    out = slic_lloyd_reference(lab, c0, height=4, width=4, n_iter=2,
                               ratio=0.1, window=1.0)
    assert out.shape == (1, 16) and (out == 0).all()


def test_cpu_wrapper_runs_the_plain_version(rng):
    """On CPU tensors the wrapper computes the plain version and does not
    count a kernel launch."""
    lab = torch.from_numpy(rng.rand(2, 3, 24 * 24).astype(np.float32) * 50)
    c0 = torch.from_numpy(np.stack([np.concatenate(
        [rng.rand(9, 3) * 50, np.stack(np.meshgrid(
            [4.0, 12.0, 20.0], [4.0, 12.0, 20.0], indexing="ij"),
            -1).reshape(9, 2)], 1)] * 2).astype(np.float32))
    before = slic_lloyd.launches
    kw = dict(height=24, width=24, n_iter=3, ratio=1.0, window=16.0)
    np.testing.assert_array_equal(slic_lloyd(lab, c0, **kw).numpy(),
                                  slic_lloyd_reference(lab, c0, **kw))
    assert slic_lloyd.launches == before


def test_wrapper_validates_inputs():
    lab = torch.zeros((1, 3, 16))
    with pytest.raises(ValueError):
        slic_lloyd(lab, torch.zeros((1, 129, 5)), height=4, width=4,
                   n_iter=1, ratio=1.0, window=1.0)
    with pytest.raises(ValueError):
        slic_lloyd(lab, torch.zeros((1, 2, 5)), height=4, width=5,
                   n_iter=1, ratio=1.0, window=1.0)
    with pytest.raises(TypeError):
        slic_lloyd(lab.double(), torch.zeros((1, 2, 5)).double(), height=4,
                   width=4, n_iter=1, ratio=1.0, window=1.0)
