"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
elsewhere; ``python -m pytest -m cuda --noconftest
tests/test_torch_cuda.py`` runs them on the card.  Tolerance: none.
SLIC labels are equal bit for bit (the kernels and their plain versions
do the same integer sums and the same float32 operations in the same
order, and so do the two SLIC engines); pooled values, codes and
gradients are equal bit for bit (each is one input element selected by
a compare, or zero)."""

import numpy as np
import pytest
import torch

from spalign_tpu_torch.kernels import pooling as tpk
from spalign_tpu_torch.kernels import slic as tslic
from spalign_tpu_torch.kernels import slic_assign as tsa
from spalign_tpu_torch.kernels.slic_fused import (slic_lloyd,
                                                  slic_lloyd_reference)
from spalign_tpu_torch.ops.pooling import max_pool_argmax_2x2, max_unpool_2x2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (marker: cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, h, w, n_seg, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.nn.functional.interpolate(
        torch.rand((b, 3, h // 8, w // 8), generator=g) * 255,
        size=(h, w), mode="bicubic").clamp(0, 255).permute(0, 2, 3, 1)
    lab = tslic.rgb_to_lab(img.to(dev) / 255.0)
    cyx, step, _, _ = tslic._init_centers(h, w, n_seg)
    cyx = torch.from_numpy(cyx).to(dev)
    c0 = torch.cat([lab[:, cyx[:, 0].long(), cyx[:, 1].long()],
                    cyx.expand(b, -1, 2)], -1).contiguous()
    labp = lab.permute(0, 3, 1, 2).reshape(b, 3, h * w).contiguous()
    return labp, c0, dict(height=h, width=w, n_iter=10,
                          ratio=10.0 / step, window=2.0 * step)


@pytest.mark.parametrize("b,h,w,n_seg", [(4, 224, 224, 100),
                                         (3, 96, 130, 40),
                                         (2, 64, 64, 128)])
def test_kernel_equals_plain_version(cuda, b, h, w, n_seg):
    lab, c0, kw = _inputs(cuda, b, h, w, n_seg)
    before = slic_lloyd.launches
    got = slic_lloyd(lab, c0, **kw)
    torch.cuda.synchronize()
    assert slic_lloyd.launches == before + 1
    want = slic_lloyd_reference(lab, c0, **kw)
    assert torch.equal(got, want)


def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    lab, c0, kw = _inputs(cuda, 1, 32, 32, 9)
    import spalign_tpu_torch.kernels.slic_fused as mod

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(mod, "slic_lloyd_reference", boom)
    out = slic_lloyd(lab, c0, **kw)
    assert out.shape == (1, 32 * 32) and out.min() >= 0
    assert np.all(out.cpu().numpy() < c0.shape[1])


# ---- the SLIC assignment kernel (csrc/slic_assign.cu) ----


@pytest.mark.parametrize("b,h,w,n_seg,case", [
    (3, 256, 512, 100, "grid"),
    (2, 250, 333, 100, "ragged"),  # H*W not a multiple of the block
    (2, 200, 300, 300, "grid"),  # K > 128
    (2, 96, 130, 40, "empty"),  # every window empty: the fallback
])
def test_assign_kernel_equals_plain_version(cuda, b, h, w, n_seg, case):
    lab, c0, kw = _inputs(cuda, b, h, w, n_seg)
    kw = {k: v for k, v in kw.items() if k != "n_iter"}
    if case == "empty":
        c0 = c0.clone()
        c0[..., 3] += 10 * h
    before = tsa.slic_assign.launches
    got = tsa.slic_assign(lab, c0, **kw)
    torch.cuda.synchronize()
    assert tsa.slic_assign.launches == before + 1
    assert torch.equal(got, tsa.slic_assign_reference(lab, c0, **kw))


@pytest.mark.parametrize("b,h,w,n_seg", [(4, 224, 224, 100),
                                         (3, 96, 130, 40)])
def test_engines_equal_on_the_card(cuda, b, h, w, n_seg):
    lab, c0, kw = _inputs(cuda, b, h, w, n_seg)
    before = tsa.slic_assign.launches
    sweep = tslic.slic_per_sweep(lab, c0, **kw)
    assert tsa.slic_assign.launches == before + kw["n_iter"] + 1
    assert torch.equal(sweep, slic_lloyd(lab, c0, **kw))


def test_overlaps_batch_launches_the_assignment_kernel(cuda):
    """One overlaps batch: n_iter + 1 assignment launches, full-res
    masks."""
    from spalign_tpu_torch import config
    from spalign_tpu_torch.pipeline.direct import make_label_generator

    sp = config.SuperpixelConfig(method="slic", n_slic_segments=40,
                                 slic_iters=3,
                                 slic_enforce_connectivity=False)
    gen = make_label_generator(config.LabelGenConfig(
        mode="overlaps", batchsize=2, resize_shape=(112, 112),
        upload_format="yuv420", superpixel=sp, save_masks=False))
    g = torch.Generator().manual_seed(0)
    full = (torch.rand((2, 128, 256, 3), generator=g) * 255).to(
        torch.uint8).numpy()
    imgs = full[:, :112, :112]
    before = tsa.slic_assign.launches
    road, _, diag, _ = gen.run_batch(imgs, full_images=full)
    torch.cuda.synchronize()
    assert tsa.slic_assign.launches == before + sp.slic_iters + 1
    assert road.shape == (2, 128, 256) and road.is_cuda
    assert diag["n_superpixels"] == [36, 36]


def test_assign_never_takes_the_plain_path(cuda, monkeypatch):
    lab, c0, kw = _inputs(cuda, 2, 64, 96, 40)

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(tsa, "slic_assign_reference", boom)
    out = tslic.slic_per_sweep(lab, c0, **kw)
    assert out.shape == (2, 64 * 96) and int(out.min()) >= 0
    assert int(out.max()) < c0.shape[1]


# ---- the SegNet pooling kernels (csrc/pooling.cu) ----


def _pool_input(dev, shape, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    x[x.abs() < 0.4] = 0.0  # ties, as after relu
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 128, 64), (2, 16, 32, 512),
                                   (3, 10, 14, 64), (1, 6, 10, 3)],
                         ids=["c64", "c512", "ragged_w", "scalar_c3"])
def test_pooling_kernels_equal_plain_versions(cuda, shape, dtype):
    x = _pool_input(cuda, shape, dtype)
    before = (tpk.pool2x2.launches, tpk.scatter2x2.launches,
              tpk.gather2x2.launches)
    pooled, codes = tpk.pool2x2(x)
    p_ref, c_ref = tpk.pool2x2_reference(x)
    y = _pool_input(cuda, pooled.shape, dtype, seed=1)
    up = tpk.scatter2x2(y, codes)
    g = _pool_input(cuda, shape, dtype, seed=2)
    down = tpk.gather2x2(g, codes)
    torch.cuda.synchronize()
    assert (tpk.pool2x2.launches, tpk.scatter2x2.launches,
            tpk.gather2x2.launches) == tuple(b + 1 for b in before)
    assert torch.equal(pooled, p_ref) and torch.equal(codes, c_ref)
    assert torch.equal(up, tpk.scatter2x2_reference(y, codes))
    assert torch.equal(down, tpk.gather2x2_reference(g, codes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_odd_input_through_the_ops_layer(cuda, dtype):
    """Odd H and W: the -inf pad in the ops layer, then the kernels;
    values and gradients equal the plain CPU path's."""
    x = _pool_input(cuda, (2, 9, 13, 64), dtype)
    w = _pool_input(cuda, (2, 9, 13, 64), dtype, seed=3)
    outs = []
    for t in (x, x.cpu()):
        t = t.clone().requires_grad_(True)
        pooled, codes = max_pool_argmax_2x2(t)
        up = max_unpool_2x2(pooled * 2, codes, out_hw=(9, 13))
        (up * w.to(t.device)).sum().backward()
        outs.append((pooled, codes, up, t.grad))
    for a, b in zip(*outs):
        assert torch.equal(a.detach().cpu(), b.detach())


def test_pooling_never_takes_the_plain_path(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("pool2x2_reference", "scatter2x2_reference",
                 "gather2x2_reference"):
        monkeypatch.setattr(tpk, name, boom)
    import spalign_tpu_torch.ops.pooling as ops_pooling

    monkeypatch.setattr(ops_pooling, "pool2x2_reference", boom)
    monkeypatch.setattr(ops_pooling, "scatter2x2_reference", boom)
    x = _pool_input(cuda, (2, 8, 12, 64), torch.float32).requires_grad_(True)
    pooled, codes = max_pool_argmax_2x2(x)
    max_unpool_2x2(pooled, codes).sum().backward()
    assert x.grad.shape == x.shape


def test_segnet_basic_train_step_launch_counts(cuda, tmp_path):
    """One SegNetBasic train step: 4 pools, 8 scatters (4 unpools
    forward, 4 pool backwards), 4 gathers (4 unpool backwards)."""
    from spalign_tpu_torch.config import TrainConfig
    from spalign_tpu_torch.train.trainer import Trainer

    tr = Trainer(TrainConfig(batchsize=2, input_shape=(64, 128),
                             result_dir=str(tmp_path)))
    g = torch.Generator(device=cuda).manual_seed(0)
    images = torch.randn((2, 64, 128, 3), generator=g, device=cuda)
    labels = (torch.rand((2, 64, 128), generator=g, device=cuda)
              > 0.5).to(torch.int32)
    tpk.reset_launches()
    loss = tr.train_step(images, labels)["loss"]
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert (tpk.pool2x2.launches, tpk.scatter2x2.launches,
            tpk.gather2x2.launches) == (4, 8, 4)
