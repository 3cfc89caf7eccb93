"""DRN-D-105 (bottleneck blocks, the D stem) in the port against the
benchmark's plain reference (``perfbench/reference/drn_d.py``), on the CPU
at its published widths and depth with seeded random weights from the
benchmark's D weights table; and its convolution count
(``perfbench/counts/drn_d_105_flops.py``), by hand and against forward
hooks on the port's modules.

Tolerance of the features: ||port - reference|| / ||reference|| below
1e-4, both in float32.  The two differ only in the order of float32
roundings (nn.BatchNorm2d's eval form against the reference's folded
scale and shift, the backend's convolution algorithm): 1.5e-6 at 32x32
over 108 convolutions.  One bf16 rounding is ~4e-3, and the port in bf16
reads ~1e-2, far above it.  The label generator's folded backbone is
held to the same bar."""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench import harness, scenes, weights
from perfbench.counts import drn_c_26_flops, drn_d_105_flops
from perfbench.drivers import label as pb_label
from perfbench.reference import drn_d as ref_drn_d
from perfbench.reference import spalign as ref
from perfbench.weights_drn_d import drn_d_shapes
from spalign_tpu_torch.models.drn import DRN_FACTORIES, preprocess_imagenet

torch.set_num_threads(4)

FEAT_REL = 1e-4
SEED = 2 ** 31 + 105


def _config():
    return json.loads((harness.HERE / "configs"
                       / "drnd105-spalign-slic.json").read_text())


@pytest.fixture(scope="module")
def net():
    """The port's drn_d_105 on the CPU in float32 with the table's seeded
    weights, and those weights."""
    sd = weights.make(drn_d_shapes(_config()["model"]), SEED, "cpu", 1.0)
    port = DRN_FACTORIES["drn_d_105"](device="cpu")
    port.load_state_dict(sd, strict=True)
    return port, sd


def _images(n, hw, seed=3):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (n, *hw, 3)).astype(np.uint8))


def _rel(a, b):
    return float(((a - b).flatten(1).norm(dim=1)
                  / b.flatten(1).norm(dim=1)).max())


def test_weights_table_names_every_parameter(net):
    port, sd = net
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    n = sum(v.numel() for k, v in sd.items()
            if k.endswith("weight") and v.dim() == 4)
    assert n == 54_180_912 + 1000 * 512  # convolutions up to map 7, fc


def test_features_match_reference_and_bf16_does_not(net):
    """Stage-8 features of 2 images of 32x32: float32 within FEAT_REL of
    the reference, the port in bf16 (the card's precision) over it."""
    port, sd = net
    imgs = _images(2, (32, 32))
    want = ref_drn_d.features(sd, _config()["model"], imgs)
    with torch.no_grad():
        got = port.features(preprocess_imagenet(imgs))
        assert got.shape == want.shape == (2, 4, 4, 512)
        assert _rel(got, want) < FEAT_REL
        low = copy.deepcopy(port).to(torch.bfloat16).features(
            preprocess_imagenet(imgs))
    assert _rel(low, want) > FEAT_REL


def test_label_unit_agrees_with_the_reference_chain(net):
    """``make_label_generator(..., model_name="drn_d_105")`` in float32 on
    one unit of 2 groups of 2 images at 64x64: its features match the D
    reference of the decoded wire, and its masks the reference's align,
    prior, k-means and paint on the program's features, maps and draws.  The
    backbone runs under a ``label.features`` device span and counts its
    images."""
    from spalign_tpu_torch.pipeline.direct import make_label_generator
    from spalign_tpu_torch.utils import timers

    _, sd = net
    cfg = _config()
    cfg["label_gen"].update(resize_shape=[64, 64], batchsize=2,
                            groups_per_dispatch=2, model_dtype="float32")
    hw = (64, 64)
    gen = make_label_generator(pb_label.label_config(cfg), state_dict=sd,
                               model_name="drn_d_105", seed=7, device="cpu")
    frames, _ = scenes.render(11, 4, (128, 256))
    wire = torch.from_numpy(ref.pack_yuv420(pb_label.resize_u8(
        frames, hw, torch.device("cpu"))))
    seeds = [123, 456]
    seen = []
    features = gen.features

    def keep(images):
        seen.append(features(images))
        return seen[-1]

    gen.features = keep
    timers.reset()
    out = gen.run_unit(wire, seeds)
    assert timers.counts()["drn.images"] == 4
    spans = [s for s in timers.spans() if s.name == "label.features"]
    assert len(spans) == 1 and spans[0].device_ns > 0
    want = ref_drn_d.features(sd, cfg["model"], ref.decode_yuv420(wire, hw))
    assert _rel(seen[0], want) < FEAT_REL
    sps = out["superpixels"].long()
    masks = ref.masks(seen[0], sps, seeds, cfg)
    assert torch.equal(out["road"], masks)


def test_flop_table_by_hand():
    model = _config()["model"]
    table = drn_d_105_flops.conv_table(model, (224, 224))
    assert len(table) == 108
    assert table[0] == ("layer0.0", 3, 16, 7, 224, 224)
    # the stride of a bottleneck is on its 3x3: the 1x1 before it reads
    # the larger map
    assert ("layer3.0.conv1", 32, 64, 1, 112, 112) in table
    assert ("layer3.0.conv2", 64, 64, 3, 56, 56) in table
    assert ("layer3.0.downsample", 32, 256, 1, 56, 56) in table
    assert ("layer6.2.conv3", 512, 2048, 1, 28, 28) in table
    assert ("layer7.0", 2048, 512, 3, 28, 28) in table
    # stage 5's 22 bottlenecks after its first, at 28^2: 1024 -> 256,
    # 256 -> 256 (3x3), 256 -> 1024
    assert 2 * 28 * 28 * (1024 * 256 + 256 * 256 * 9 + 256 * 1024) == \
        1_746_927_616
    assert sum(2 * ho * wo * ci * co * k * k
               for name, ci, co, k, ho, wo in table
               if name.startswith("layer5.") and
               not name.startswith("layer5.0.")) == 22 * 1_746_927_616
    assert drn_d_105_flops.flops_per_image(model, (224, 224)) == \
        86_670_409_728
    c26 = json.loads((harness.HERE / "configs"
                      / "drn26-spalign-slic.json").read_text())["model"]
    assert drn_c_26_flops.flops_per_image(c26, (224, 224)) == \
        33_941_454_848


@pytest.mark.parametrize("hw", [(32, 32), (40, 56)])
def test_flop_table_against_hooks(net, hw):
    port, _ = net
    seen = []

    def hook(mod, _inp, out):
        n, _, ho, wo = out.shape
        co, ci, kh, kw = mod.weight.shape
        seen.append(2 * n * ho * wo * co * ci * kh * kw)

    hs = [m.register_forward_hook(hook) for m in port.modules()
          if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            port.features(preprocess_imagenet(torch.zeros(2, *hw, 3)))
    finally:
        for h in hs:
            h.remove()
    assert len(seen) == 108
    assert sum(seen) == 2 * drn_d_105_flops.flops_per_image(
        _config()["model"], hw)


@pytest.mark.parametrize("init,folds", [("device", True),
                                        ("reference", False)])
def test_backbone_folds_outside_the_parity_mode(init, folds):
    """The routing predicate: the folded DRN serves the backbone on any
    device, except in the parity mode (the reference's float32
    arithmetic, BN unfolded)."""
    from spalign_tpu_torch.pipeline.label_gen import LabelGeneratorBase

    cfg = pb_label.label_config(_config())
    cfg = dataclasses.replace(cfg, kmeans=dataclasses.replace(
        cfg.kmeans, init=init))
    assert LabelGeneratorBase._folds(cfg) is folds


def test_parity_generator_serves_the_drn_with_its_bn():
    """In the parity mode the backbone is the DRN itself (``gen.net is
    gen.model``, BN unfolded, float32), no folded net is built, and
    ``drn.folded_images`` reads 0 beside ``drn.images``."""
    from spalign_tpu_torch.config import KMeansConfig, LabelGenConfig
    from spalign_tpu_torch.models.drn import DRN
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator
    from spalign_tpu_torch.utils import timers

    cfg = LabelGenConfig(batchsize=2, resize_shape=(64, 64),
                         save_masks=False,
                         kmeans=KMeansConfig(n_clusters=4, seed=1111,
                                             init="reference"))
    gen = SpalignLabelGenerator(cfg, device="cpu")
    assert gen.net is gen.model and isinstance(gen.model, DRN)
    assert any(isinstance(m, torch.nn.BatchNorm2d)
               for m in gen.net.modules())
    assert next(gen.net.parameters()).dtype == torch.float32
    timers.reset()
    feats = gen.features(_images(2, (64, 64)))
    assert feats.shape[0] == 2 and feats.dtype == torch.float32
    c = timers.counts()
    assert c["drn.images"] == 2 and c["drn.folded_images"] == 0


def _unit_config(model_dtype):
    cfg = _config()
    cfg["label_gen"].update(resize_shape=[64, 64], batchsize=2,
                            groups_per_dispatch=1, model_dtype=model_dtype)
    return pb_label.label_config(cfg)


@pytest.mark.parametrize("folded", [False, True],
                         ids=["unfolded", "folded"])
def test_generator_keeps_its_drn_beside_the_folded_one(net, monkeypatch,
                                                       folded):
    """``gen.model`` is the DRN with the given weights and BN, in the
    config's dtype, after the build and after ``reconfigure`` to another
    dtype, whether or not the folded net serves the backbone.  Folded
    (this config's routing) ``gen.net``, the folded DRN-D-105, serves
    ``features`` within FEAT_REL of the reference, counted under
    ``drn.folded_images``, and keeps the 108 convolutions of the table;
    unfolded (forced) ``gen.net`` is the DRN and the counter reads 0."""
    from spalign_tpu_torch.models.drn import DRN, FoldedDRN
    from spalign_tpu_torch.pipeline.direct import make_label_generator
    from spalign_tpu_torch.pipeline.label_gen import LabelGeneratorBase
    from spalign_tpu_torch.utils import timers

    _, sd = net
    if not folded:
        monkeypatch.setattr(LabelGeneratorBase, "_folds",
                            staticmethod(lambda cfg: False))
    gen = make_label_generator(_unit_config("float32"), state_dict=sd,
                               model_name="drn_d_105", seed=7, device="cpu")

    def assert_model(dtype):
        assert isinstance(gen.model, DRN)
        got = gen.model.state_dict()
        assert set(got) == set(sd)
        for k, v in got.items():
            want = sd[k] if v.dtype == torch.int64 else sd[k].to(dtype)
            assert v.dtype == want.dtype and torch.equal(v, want), k
        if folded:
            assert isinstance(gen.net, FoldedDRN)
            assert gen.net.stem.conv.weight.dtype == dtype
            assert gen.net.stem.shift.dtype == torch.float32
        else:
            assert gen.net is gen.model

    assert_model(torch.float32)
    imgs = _images(2, (64, 64))
    timers.reset()
    convs = []
    hs = [m.register_forward_hook(lambda *a: convs.append(1))
          for m in gen.net.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        feats = gen.features(imgs)
    finally:
        for h in hs:
            h.remove()
    assert len(convs) == 108
    c = timers.counts()
    assert c["drn.images"] == 2
    assert c["drn.folded_images"] == (2 if folded else 0)
    want = ref_drn_d.features(sd, _config()["model"], imgs)
    assert _rel(feats, want) < FEAT_REL
    gen.reconfigure(_unit_config("bfloat16"))
    assert_model(torch.bfloat16)
