"""The port's DRN (spalign_tpu_torch/models/drn.py) and the flax -> torch
weight bridge (spalign_tpu_torch/convert/from_jax.py); the DRN's folded
inference form (``fold_drn``) and its epilogue's plain version
(spalign_tpu_torch/kernels/drn_epilogue.py).

Tolerance: stage outputs within 1e-4 of the largest |value| in float32
on the CPU, the converter's bar (reference convert_pth2ch.py:57-73).  The
folded features within 1e-5 relative of the DRN's in float32: the two
differ only in where float32 rounds (W * s once against BN after the
convolution), ~2.6e-6 for DRN-D-105 at 64x64.  The epilogue's plain
version equals its formula bit for bit (the same float32 sums, one
rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch import nn

from perfbench import weights
from spalign_tpu.models.drn import DRN_FACTORIES as FLAX_DRN
from spalign_tpu.models.drn import preprocess_imagenet as flax_preprocess
from spalign_tpu_torch.convert.from_jax import drn_state_dict_from_flax
from spalign_tpu_torch.kernels.drn_epilogue import (drn_epilogue,
                                                    drn_epilogue_reference)
from spalign_tpu_torch.models.drn import (DRN, DRN_FACTORIES, BasicBlock,
                                          FoldedDRN, fold_drn,
                                          preprocess_imagenet)

torch.set_num_threads(2)


def _flax_variables(name, hw, seed=1):
    model = FLAX_DRN[name](out_map=True, out_middle=True)
    variables = jax.device_get(model.init(
        jax.random.key(seed), jnp.zeros((1, *hw, 3), jnp.float32)))
    # non-trivial BN statistics so the bridge of every leaf is exercised
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(
        lambda a: (np.asarray(a) + rng.uniform(0.05, 0.2, np.shape(a))
                   ).astype(np.float32), variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("name", ["drn_c_26", "drn_d_22", "drn_d_105"])
def test_stage_outputs_match_flax(name):
    hw = (64, 64)
    model, variables = _flax_variables(name, hw)
    x = np.random.RandomState(0).rand(2, *hw, 3).astype(np.float32) * 255
    out_f, maps_f = model.apply(variables, flax_preprocess(jnp.asarray(x)),
                                train=False)
    port = DRN_FACTORIES[name](device="cpu")
    port.load_state_dict(drn_state_dict_from_flax(variables,
                                                  arch=name[4].upper()),
                         strict=True)
    with torch.no_grad():
        out_t, maps_t = port(preprocess_imagenet(torch.from_numpy(x)))
    assert len(maps_t) == len(maps_f) == 8
    for mf, mt in zip(maps_f, maps_t):
        mf = np.asarray(mf)
        assert mt.shape == mf.shape
        assert np.abs(mt.numpy() - mf).max() <= 1e-4 * np.abs(mf).max()
    out_f = np.asarray(out_f)
    assert np.abs(out_t.numpy() - out_f).max() <= 1e-4 * np.abs(out_f).max()
    # the label path's entry: maps[7] only, head skipped
    with torch.no_grad():
        feats = port.features(preprocess_imagenet(torch.from_numpy(x)))
    np.testing.assert_array_equal(feats.numpy(), maps_t[7].numpy())
    assert feats.shape == (2, 8, 8, 512)


def test_bridge_covers_every_parameter():
    _, variables = _flax_variables("drn_c_26", (64, 64))
    sd = drn_state_dict_from_flax(variables)
    port = DRN_FACTORIES["drn_c_26"](device="cpu")
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    n_flax = sum(np.size(a) for a in jax.tree.leaves(variables))
    n_port = sum(v.numel() for k, v in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_preprocess_matches_flax():
    x = np.random.RandomState(2).randint(0, 256, (2, 5, 7, 3)).astype(
        np.uint8)
    np.testing.assert_allclose(
        preprocess_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(flax_preprocess(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_random_init_is_seeded():
    a = DRN_FACTORIES["drn_c_26"](device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    b = DRN_FACTORIES["drn_c_26"](device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize("single", [False, True], ids=["batch", "single"])
def test_batch_predict_and_predict_match_flax(single):
    """``batch_predict`` / ``predict`` (ImageNet normalisation inside, eval
    mode) against the JAX package's on the same weights: the head and
    every stage map within the converter's bar, NHWC both."""
    from spalign_tpu.models.drn import batch_predict as flax_batch_predict
    from spalign_tpu.models.drn import predict as flax_predict
    from spalign_tpu_torch.models.drn import batch_predict, predict

    hw = (32, 32)
    model, variables = _flax_variables("drn_d_22", hw)
    x = np.random.RandomState(4).randint(0, 256, (2, *hw, 3)).astype(
        np.float32)
    port = DRN_FACTORIES["drn_d_22"](device="cpu")
    port.load_state_dict(drn_state_dict_from_flax(variables, arch="D"),
                         strict=True)
    if single:
        want = flax_predict(model, variables, jnp.asarray(x[0]))
        got = predict(port, torch.from_numpy(x[0]))
    else:
        want = flax_batch_predict(model, variables, jnp.asarray(x))
        got = batch_predict(port, torch.from_numpy(x))
    assert not port.training and not got[0].requires_grad
    pairs = [(got[0], want[0])] + list(zip(got[1], want[1]))
    assert len(pairs) == 9
    for t, f in pairs:
        f = np.asarray(f)
        assert tuple(t.shape) == f.shape and f.shape[0] == (1 if single
                                                            else 2)
        assert np.abs(t.numpy() - f).max() <= 1e-4 * np.abs(f).max()


# ---- the folded inference form and its epilogue ----


def _drawn(model: DRN, seed: int) -> DRN:
    """``model`` with weights drawn as the benchmark draws them
    (``perfbench/weights.py``: no batch norm is the identity)."""
    shapes = [(n, tuple(m.weight.shape)) if isinstance(m, nn.Conv2d)
              else (n, m.num_features) for n, m in model.named_modules()
              if isinstance(m, (nn.Conv2d, nn.BatchNorm2d))]
    model.load_state_dict(weights.make(shapes, seed, "cpu", 1.0),
                          strict=True)
    return model


_NETS = {
    "drn_c_26": lambda: DRN_FACTORIES["drn_c_26"](device="cpu"),
    "drn_d_105": lambda: DRN_FACTORIES["drn_d_105"](device="cpu"),
    # basic blocks whose last two stages add no skip although their
    # channel counts change (a downsample built and never run)
    "basic_no_residual": lambda: DRN(
        BasicBlock, (1, 1, 1, 1, 1, 1, 1, 1),
        channels=(16, 32, 64, 128, 256, 512, 256, 128), num_classes=0,
        arch="C").eval(),
}


@pytest.mark.parametrize("name", sorted(_NETS))
def test_folded_features_equal_the_drn_in_float32(name):
    """``fold_drn(m).features`` against ``m.features`` at 64x64 in float32
    (the relative norm of the difference, worst image), map by map; the
    DRN is left as it was."""
    model = _drawn(_NETS[name](), 2 ** 31 + 23)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    folded = fold_drn(model)
    assert isinstance(folded, FoldedDRN)
    assert not any(isinstance(m, nn.BatchNorm2d) for m in folded.modules())
    x = preprocess_imagenet(torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (2, 64, 64, 3)).astype(np.uint8)))
    assert len(folded.stages) == 8
    for i in range(8):
        with torch.no_grad():
            want = model.features(x, (i,))
            got = folded.features(x, (i,))
        assert got.shape == want.shape and got.dtype == torch.float32
        rel = ((got - want).flatten(1).norm(dim=1)
               / want.flatten(1).norm(dim=1)).max()
        assert float(rel) < 1e-5, i
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["bias", "bias_residual"])
def test_epilogue_plain_version_is_its_formula(residual, dtype):
    """``drn_epilogue`` on CPU tensors (its plain version) writes
    relu((y + bias) + residual), summed in float32 in that order and
    rounded once, into y."""
    rng = np.random.RandomState(7)
    shape = (3, 16, 5, 7)
    y = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.randn(16).astype(np.float32))
    r = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
         if residual else None)
    want = y.float().numpy() + bias.numpy()[None, :, None, None]
    if residual:
        want = want + r.float().numpy()
    want = np.maximum(want, np.float32(0))
    want = torch.from_numpy(want.astype(np.float32)).to(dtype)
    plain = drn_epilogue_reference(y, bias, r)
    out = drn_epilogue(y, bias, r)
    assert out is y
    assert torch.equal(y, want) and torch.equal(plain, want)
    assert not bool((y < 0).any()) and bool((y == 0).any())


@pytest.mark.parametrize("case", ["float16", "bias_shape", "bias_dtype",
                                  "residual_dtype", "residual_shape"])
def test_epilogue_checks_raise(case):
    y = torch.zeros(2, 16, 3, 3, dtype=torch.bfloat16)
    bias, r = torch.zeros(16), None
    if case == "float16":
        y = y.to(torch.float16)
    elif case == "bias_shape":
        bias = torch.zeros(8)
    elif case == "bias_dtype":
        bias = bias.to(torch.bfloat16)
    elif case == "residual_dtype":
        r = torch.zeros(2, 16, 3, 3)
    else:
        r = torch.zeros(2, 16, 3, 2, dtype=torch.bfloat16)
    with pytest.raises(TypeError if case == "float16" else ValueError):
        drn_epilogue(y, bias, r)
