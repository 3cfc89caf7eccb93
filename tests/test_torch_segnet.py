"""The port's SegNets (spalign_tpu_torch/models/segnet.py), LRN and
bilinear resize against the JAX package, with the flax weights carried
across by convert/from_jax.py::segnet_state_dict_from_flax.

Tolerances, float32 on the CPU: LRN rtol 1e-6 (the same cumsum
formula); model outputs within 1e-4 of the largest |value| (the DRN
converter's bar: convolutions sum in another order); BN running
statistics rtol 1e-5; resized scores atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.models.segnet import SegNet as FlaxSegNet
from spalign_tpu.models.segnet import SegNetBasic as FlaxSegNetBasic
from spalign_tpu.models.segnet import predict_labels as flax_predict
from spalign_tpu.ops.lrn import local_response_normalization as jlrn
from spalign_tpu.ops.resize import bilinear_resize as jresize
from spalign_tpu_torch.convert.from_jax import segnet_state_dict_from_flax
from spalign_tpu_torch.models.segnet import (SegNet, SegNetBasic,
                                             build_segnet, predict_labels)
from spalign_tpu_torch.ops.lrn import local_response_normalization
from spalign_tpu_torch.ops.resize import bilinear_resize

torch.set_num_threads(2)
HW = (32, 64)
MODELS = {"basic": (FlaxSegNetBasic, SegNetBasic),
          "normal": (FlaxSegNet, SegNet)}


def _carried(kind, seed=1):
    """(flax module, variables with non-trivial BN statistics, the port's
    module loaded with the same weights)."""
    fmodel = MODELS[kind][0](n_class=2)
    v = jax.device_get(fmodel.init(jax.random.key(seed),
                                   jnp.zeros((1, *HW, 3)), train=False))
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(
        lambda a: (np.asarray(a) + rng.uniform(0.05, 0.2, np.shape(a))
                   ).astype(np.float32), v["batch_stats"])
    variables = {"params": v["params"], "batch_stats": stats}
    port = MODELS[kind][1](n_class=2)
    port.load_state_dict(segnet_state_dict_from_flax(variables, kind),
                         strict=True)
    return fmodel, variables, port


def _images(seed=0, n=2):
    return np.random.RandomState(seed).randn(n, *HW, 3).astype(np.float32)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("shape,kw", [
    ((2, 5, 7, 3), dict(n=5, k=1.0, alpha=1e-4 / 5.0, beta=0.75)),
    ((2, 4, 4, 64), dict()),
    ((3, 9), dict(n=3, k=2.0, alpha=0.3, beta=0.5)),
])
def test_lrn_matches_jax(shape, kw):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32) * 20
    want = np.asarray(jlrn(jnp.asarray(x), **kw))
    got = local_response_normalization(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", MODELS)
def test_eval_output_matches_flax(kind):
    fmodel, variables, port = _carried(kind)
    x = _images()
    want = fmodel.apply(variables, jnp.asarray(x), train=False)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("kind", MODELS)
def test_train_mode_output_and_running_stats_match_flax(kind):
    """Batch statistics in the forward; running averages 0.9 old + 0.1
    new with the biased batch variance, as flax updates them."""
    fmodel, variables, port = _carried(kind)
    x = _images(4)
    want, mutated = fmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, want)
    new = segnet_state_dict_from_flax(
        {"batch_stats": jax.device_get(mutated["batch_stats"])}, kind)
    sd = port.state_dict()
    assert len(new) > 0
    for k, v in new.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", MODELS)
def test_bridge_covers_every_parameter(kind):
    _, variables, port = _carried(kind)
    sd = segnet_state_dict_from_flax(variables, kind)
    assert set(sd) == set(port.state_dict())
    n_flax = sum(np.size(a) for a in jax.tree.leaves(variables))
    n_port = sum(v.numel() for k, v in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_segnet_basic_inventory():
    """Bias conventions and BN shift init of the reference ctor args."""
    m = build_segnet("basic", device="cpu")
    assert m.conv1.weight.shape == (64, 3, 7, 7) and m.conv1.bias is None
    assert m.conv_decode1.bias is None
    assert m.conv_classifier.weight.shape == (2, 64, 1, 1)
    assert m.conv_classifier.bias is not None
    np.testing.assert_allclose(m.conv1_bn.bias.detach().numpy(), 0.001)
    s = build_segnet("normal", device="cpu")
    assert s.block1.cbr0.conv.bias is None and s.score.bias is not None
    np.testing.assert_allclose(s.block1.cbr0.bn.bias.detach().numpy(), 0.0)
    assert m.conv1_bn.eps == 2e-5


def test_init_is_flax_he_normal():
    """Truncated normal, std sqrt(2 / fan_in) after truncation, cut at
    two standard deviations of the untruncated normal."""
    m = build_segnet("basic", device="cpu",
                     generator=torch.Generator().manual_seed(5))
    w = m.conv_decode1.weight.detach().numpy()
    fan_in = 64 * 7 * 7
    np.testing.assert_allclose(w.std(), np.sqrt(2.0 / fan_in), rtol=0.02)
    assert np.abs(w).max() <= 2 * np.sqrt(2.0 / fan_in) / 0.8796 + 1e-7
    a = build_segnet("basic", device="cpu",
                     generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.conv1.weight, m.conv1.weight)


def test_predict_labels_matches_flax():
    fmodel, variables, port = _carried("basic")
    x = _images(5, n=1)
    labels, score = flax_predict(
        lambda v, im, train: fmodel.apply(v, im, train=train), variables,
        jnp.asarray(x), pred_shape=(64, 128), return_score=True)
    got_l, got_s = predict_labels(port, torch.from_numpy(x),
                                  pred_shape=(64, 128), return_score=True)
    assert got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(labels))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(score), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape,out_hw,axes", [
    ((2, 5, 7, 3), (10, 14), (1, 2)),  # upsampling, NHWC
    ((2, 16, 20, 3), (7, 9), (1, 2)),  # shrinking (antialiased)
    ((6, 4, 2), (13, 5), (0, 1)),  # HWC, mixed
    ((2, 3, 8, 6), (16, 3), (2, 3)),  # NCHW, mixed
])
def test_bilinear_resize_matches_jax(shape, out_hw, axes):
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), out_hw, spatial_axes=axes))
    got = bilinear_resize(torch.from_numpy(x), out_hw,
                          spatial_axes=axes).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
