"""The CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
elsewhere; ``python -m pytest -m cuda tests/test_torch_cuda.py`` runs
them on the card.  Tolerance: labels equal bit for bit (the kernel and
its plain version do the same integer sums and the same float32
operations in the same order)."""

import numpy as np
import pytest
import torch

from spalign_tpu_torch.kernels import slic as tslic
from spalign_tpu_torch.kernels.slic_fused import (slic_lloyd,
                                                  slic_lloyd_reference)

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
