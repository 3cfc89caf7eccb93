"""The port's SLIC assignment step and per-sweep engine against the JAX
package, on the CPU.

The plain version of the assignment kernel (``slic_assign_reference``,
what the wrapper runs for CPU tensors) is held to the JAX Pallas kernel
``slic_assign_pallas`` in interpret mode with the rule of
tests/test_slic_pallas.py: labels may differ only where the two squared
distances tie within 1e-4 (the port scores p.c - |c|^2/2, the TPU kernel
the expanded distance: the same argmin up to rounding), on fewer than 1%
of the pixels.  The whole per-sweep SLIC is held to JAX's dense sweep at
>= 0.995 agreement (the bar of tests/test_slic_pallas.py:122) and to the
port's Lloyd engine exactly."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu.kernels.experimental.slic_pallas import (pack_centers,
                                                          pack_pixels,
                                                          slic_assign_pallas)
from spalign_tpu_torch.kernels import slic as tslic
from spalign_tpu_torch.kernels.slic_assign import (slic_assign,
                                                   slic_assign_reference)
from spalign_tpu_torch.kernels.slic_fused import (pixel_rows,
                                                  slic_lloyd_reference,
                                                  update_centers)

jslic = importlib.import_module("spalign_tpu.kernels.slic")
torch.set_num_threads(2)


def _grid_case(img, n_seg):
    """JAX's LAB of ``img`` and its grid centres (the inputs of
    tests/test_slic_pallas.py): (lab (H, W, 3), centres (K, 5), step)."""
    h, w, _ = img.shape
    lab = np.asarray(jslic.rgb_to_lab(jnp.asarray(img / 255.0)))
    centers_yx, step = jslic._init_centers(h, w, n_seg)[:2]
    c_lab = lab[np.clip(centers_yx[:, 0].astype(int), 0, h - 1),
                np.clip(centers_yx[:, 1].astype(int), 0, w - 1)]
    centers = np.concatenate([c_lab, centers_yx], -1).astype(np.float32)
    return lab, centers, step


def _port_assign(lab, centers, ratio, window):
    h, w, _ = lab.shape
    lab_t = torch.from_numpy(lab.reshape(1, h * w, 3).transpose(0, 2, 1)
                             .copy())
    return slic_assign_reference(
        lab_t, torch.from_numpy(centers[None]), height=h, width=w,
        ratio=ratio, window=window)[0].numpy()


def _jax_assign(lab, centers, ratio, window):
    h, w, _ = lab.shape
    k = centers.shape[0]
    k_pad = -(-k // 128) * 128
    out = slic_assign_pallas(pack_pixels(jnp.asarray(lab), ratio),
                             pack_centers(jnp.asarray(centers), ratio,
                                          k_pad),
                             k_real=k, window=float(window), interpret=True)
    return np.asarray(out)[: h * w]


def _sweeps(lab, centers, n, ratio, window):
    """``n`` sweeps of the port's per-sweep engine from ``centers``."""
    h, w, _ = lab.shape
    lab_t = torch.from_numpy(lab.reshape(1, h * w, 3).transpose(0, 2, 1)
                             .copy())
    rows = pixel_rows(lab_t, w)
    c = torch.from_numpy(centers[None])
    for _ in range(n):
        c = update_centers(rows, slic_assign_reference(
            lab_t, c, height=h, width=w, ratio=ratio, window=window), c)
    return c[0].numpy()


def _held_to_jax(lab, centers, ratio, window):
    """Both assignments; mismatches only at distance ties within 1e-4 and
    on < 1% of the pixels.  Returns the port's labels."""
    h, w, _ = lab.shape
    got = _port_assign(lab, centers, ratio, window)
    want = _jax_assign(lab, centers, ratio, window)
    mismatch = got != want
    if mismatch.any():
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pix = np.concatenate([lab.reshape(-1, 3), yy.reshape(-1, 1),
                              xx.reshape(-1, 1)], -1).astype(np.float32)
        scale = np.array([1, 1, 1, ratio, ratio], np.float32)
        ps, cs = pix * scale, centers * scale
        d_got = ((ps[mismatch] - cs[got[mismatch]]) ** 2).sum(-1)
        d_want = ((ps[mismatch] - cs[want[mismatch]]) ** 2).sum(-1)
        np.testing.assert_allclose(d_got, d_want, rtol=1e-4, atol=1e-4)
    assert mismatch.mean() < 0.01
    assert got.min() >= 0 and got.max() < centers.shape[0]
    return got


@pytest.mark.parametrize("h,w,n_seg,moved", [
    (64, 64, 40, 0),  # tests/test_slic_pallas.py:27 (HW = 2 tiles)
    (48, 56, 12, 0),  # its padded case (HW not a multiple of 2,048)
    (96, 128, 300, 0),  # K = 300 > 128: K_pad 384 on the TPU
    (64, 64, 40, 2),  # centres moved off the grid by 2 sweeps
    (96, 128, 300, 2),
])
def test_plain_assignment_matches_pallas_kernel(h, w, n_seg, moved):
    rng = np.random.RandomState(1111 + h + n_seg)
    img = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
    lab, centers, step = _grid_case(img, n_seg)
    ratio, window = 10.0 / step, 2.0 * step
    if n_seg == 300:
        assert centers.shape[0] > 128
    if moved:
        centers = _sweeps(lab, centers, moved, ratio, window)
        assert np.abs(centers[:, 3:] - _grid_case(img, n_seg)[1][:, 3:]
                      ).max() > 0.5
    _held_to_jax(lab, centers, ratio, window)


def test_empty_window_falls_back_to_unmasked_argmin():
    """The centres near the top-left corner parked far away: the corner
    pixels have no centre in their window and take the unmasked best, in
    both kernels."""
    rng = np.random.RandomState(7)
    img = rng.randint(0, 255, (64, 64, 3)).astype(np.float32)
    lab, centers, step = _grid_case(img, 40)
    window = 2.0 * step
    near = ((np.abs(centers[:, 3]) <= window)
            & (np.abs(centers[:, 4]) <= window))
    centers[near, 3] += 1000.0
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    in_win = ((np.abs(yy.reshape(-1, 1) - centers[None, :, 3]) <= window)
              & (np.abs(xx.reshape(-1, 1) - centers[None, :, 4]) <= window))
    empty = ~in_win.any(1)
    assert empty.sum() > 0
    got = _held_to_jax(lab, centers, 10.0 / step, window)
    assert (got[empty] >= 0).all()


@pytest.mark.parametrize("shape,n_seg,n_iter", [((96, 128), 40, 4),
                                                ((128, 256), 40, 3)])
def test_per_sweep_slic_matches_jax_dense_sweep(shape, n_seg, n_iter):
    """A synthetic scene (96x128, the input of tests/test_slic_pallas.py)
    and a frame at the overlaps tests' full resolution (128x256)."""
    img, _ = SyntheticRoadScenes(n=1, full_shape=shape, seed=5)[0]
    img = img.astype(np.float32)
    got = tslic.slic(img[None], n_segments=n_seg, n_iter=n_iter,
                     engine="assign", device="cpu")[0].numpy()
    dense = np.asarray(jslic.slic(jnp.asarray(img), n_segments=n_seg,
                                  n_iter=n_iter, use_fused=False,
                                  use_pallas=False))
    assert (got == dense).mean() >= 0.995
    assert got.min() >= 0 and got.max() < tslic.slic_grid_size(*shape,
                                                                 n_seg)


@pytest.mark.parametrize("b,h,w,n_seg,n_iter", [(2, 48, 56, 12, 3),
                                                (3, 64, 96, 40, 5),
                                                (1, 40, 300, 100, 2),
                                                (2, 32, 32, 9, 0)])
def test_engines_equal(b, h, w, n_seg, n_iter):
    """One sweep of either engine is the same arithmetic: the per-sweep
    loop equals the Lloyd loop's plain version label for label."""
    rng = np.random.RandomState(h * w)
    imgs = rng.randint(0, 255, (b, h, w, 3)).astype(np.float32)
    a = tslic.slic(imgs, n_segments=n_seg, n_iter=n_iter, device="cpu")
    s = tslic.slic(imgs, n_segments=n_seg, n_iter=n_iter, engine="assign",
                   device="cpu")
    np.testing.assert_array_equal(a.numpy(), s.numpy())


def test_update_sums_are_exact_integers():
    """The float64 bincount of the centre update sums the same integers
    as an int64 index_add_ (the fixed-point L, a, b; y, x; counts), and
    an empty centre keeps its position."""
    rng = np.random.RandomState(3)
    lab = torch.from_numpy(rng.rand(2, 3, 30 * 40).astype(np.float32)
                           * 200 - 100)
    labels = torch.from_numpy(rng.randint(0, 7, (2, 30 * 40)))
    labels[1][labels[1] == 3] = 4  # centre 3 of image 1 stays empty
    centers = torch.from_numpy(rng.rand(2, 7, 5).astype(np.float32))
    rows = pixel_rows(lab, 40)
    assert rows.dtype == torch.float64
    np.testing.assert_array_equal(rows.numpy(), np.round(rows.numpy()))
    ids = (labels + torch.arange(2)[:, None] * 7).reshape(-1)
    sums = torch.zeros((6, 14), dtype=torch.int64).index_add_(
        1, ids, rows.to(torch.int64)).to(torch.float64)
    n = sums[5:]
    want = torch.cat([sums[:3] / n / 65536.0, sums[3:5] / n]).to(
        torch.float32).T.reshape(2, 7, 5)
    got = update_centers(rows, labels, centers)
    mask = torch.ones(2, 7, dtype=torch.bool)
    mask[1, 3] = False
    np.testing.assert_array_equal(got[mask].numpy(), want[mask].numpy())
    np.testing.assert_array_equal(got[1, 3].numpy(), centers[1, 3].numpy())


def test_lloyd_plain_version_unchanged_on_shared_update(rng):
    """The Lloyd loop's plain version over the shared update equals a
    hand-rolled loop of its arithmetic (fixed-point int64 sums, float64
    means)."""
    lab = torch.from_numpy(rng.rand(1, 3, 20 * 24).astype(np.float32) * 60)
    c0 = torch.tensor([[[30.0, 0.0, 0.0, 5.0, 6.0],
                        [20.0, 1.0, 1.0, 14.0, 17.0]]])
    kw = dict(height=20, width=24, ratio=0.5, window=12.0)
    c = c0.clone()
    q = torch.round(lab[0] * 65536.0).to(torch.int64)
    py = torch.arange(480) // 24
    px = torch.arange(480) % 24
    for _ in range(3):
        lbl = slic_assign_reference(lab, c, **kw)[0].long()
        for k in range(2):
            m = lbl == k
            n = int(m.sum())
            if n:
                c[0, k, :3] = (q[:, m].sum(1).double() / n / 65536.0).float()
                c[0, k, 3] = float(py[m].sum().double() / n)
                c[0, k, 4] = float(px[m].sum().double() / n)
    want = slic_assign_reference(lab, c, **kw)
    got = slic_lloyd_reference(lab, c0, n_iter=3, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cpu_wrapper_runs_the_plain_version(rng):
    lab = torch.from_numpy(rng.rand(2, 3, 24 * 24).astype(np.float32) * 50)
    c = torch.from_numpy(rng.rand(2, 9, 5).astype(np.float32) * 20)
    kw = dict(height=24, width=24, ratio=1.0, window=8.0)
    before = slic_assign.launches
    np.testing.assert_array_equal(slic_assign(lab, c, **kw).numpy(),
                                  slic_assign_reference(lab, c, **kw))
    assert slic_assign.launches == before


def test_wrapper_and_engines_validate_inputs():
    lab = torch.zeros((1, 3, 16))
    kw = dict(height=4, width=4, ratio=1.0, window=1.0)
    with pytest.raises(ValueError):
        slic_assign(lab, torch.zeros((1, 1025, 5)), **kw)
    with pytest.raises(ValueError):
        slic_assign(lab, torch.zeros((2, 3, 5)), **kw)
    with pytest.raises(TypeError):
        slic_assign(lab.double(), torch.zeros((1, 3, 5)).double(), **kw)
    # the Lloyd engine refuses full-resolution-sized frames (32-bit
    # coordinate sums); the per-sweep engine has a bound of its own
    c = torch.zeros((1, 1, 5))
    for engine, hw in ((tslic.slic_lloyd, (2048, 2048)),
                       (tslic.slic_per_sweep, (2 ** 14, 2 ** 13))):
        big = torch.zeros((1, 3, 1)).expand(1, 3, hw[0] * hw[1])
        with pytest.raises(ValueError, match="too large"):
            engine(big, c, height=hw[0], width=hw[1], n_iter=1, ratio=1.0,
                   window=1.0)
    with pytest.raises(ValueError, match="engine"):
        tslic.slic(np.zeros((1, 8, 8, 3), np.float32), engine="dense",
                   device="cpu")
