"""The port's direct and overlaps label modes (spalign_tpu_torch/pipeline/
direct.py) and the label_gen CLI against the JAX package, on the CPU.

Both packages run the settings of tests/test_baselines.py (float32 DRN-C-26
at full width with bridged weights, 112x112 network input, 128x256 full
frames, 40 SLIC segments, 3 sweeps) and the port gets the JAX package's
k-means uniforms, rebuilt here as ``weighted_kmeans`` draws them.
Tolerances: the resize and the refine are exact (integer work); the
pixel k-means equals JAX's assignment on the given features; road masks
of a whole unit agree on >= 0.99 of the pixels (the DRN features differ
by float rounding, and the overlaps masks rest on the two SLIC sweeps,
which agree on >= 0.995 of the pixels)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.config import LabelGenConfig as JaxLabelGenConfig
from spalign_tpu.config import SuperpixelConfig as JaxSuperpixelConfig
from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu.ops.resize import nn_resize_cv2 as jax_nn_resize
from spalign_tpu.pipeline import direct as jdirect
from spalign_tpu.utils.timers import StageTimer as JaxStageTimer
from spalign_tpu_torch import config as tcfg
from spalign_tpu_torch.cli import label_gen as cli
from spalign_tpu_torch.convert.from_jax import drn_state_dict_from_flax
from spalign_tpu_torch.models.drn import DRN_FACTORIES
from spalign_tpu_torch.ops.resize import nn_resize_cv2
from spalign_tpu_torch.pipeline import direct as tdirect
from spalign_tpu_torch.pipeline.label_gen import (SpalignLabelGenerator,
                                                  unpack_mask_bits)
from spalign_tpu_torch.pipeline.superpixels import (batched_slic_device_yuv,
                                                    compute_superpixels)
from spalign_tpu_torch.pipeline.wire import pack_yuv420

torch.set_num_threads(2)

HW = (112, 112)
FULL = (128, 256)
B = 2
PRIOR = (0.75, 0.5, 0.1, 0.1)
SP = dict(method="slic", n_slic_segments=40, slic_iters=3,
          max_superpixels=256, slic_enforce_connectivity=False)
COMMON = dict(batchsize=B, resize_shape=HW, model_dtype="float32",
              upload_format="yuv420", save_masks=False)


def _port_cfg(mode, **kw):
    sp = kw.pop("superpixel", tcfg.SuperpixelConfig(**SP))
    return tcfg.LabelGenConfig(mode=mode, superpixel=sp, **dict(COMMON, **kw))


@pytest.fixture(scope="module")
def weights():
    jgen = jdirect.make_label_generator(JaxLabelGenConfig(
        mode="direct", superpixel=JaxSuperpixelConfig(**SP), **COMMON),
        seed=5)
    return jgen.variables, drn_state_dict_from_flax(
        jax.device_get(jgen.variables))


@pytest.fixture(scope="module")
def scenes():
    ds = SyntheticRoadScenes(n=2 * B, full_shape=FULL, seed=31)
    imgs, labels = ds.resized_batch(range(2 * B), HW)
    full = np.stack([ds[i][0] for i in range(2 * B)])
    return ds, imgs, labels, full


def _jax_uniforms(seeds, n):
    """The seeding uniforms of JAX's direct_cluster: one key per group."""
    return torch.from_numpy(np.stack([
        np.array(jax.random.uniform(jax.random.key(int(s)), (n,)))
        for s in seeds]))


@pytest.mark.parametrize("small,full", [((14, 14), (128, 256)),
                                        ((28, 28), (1024, 2048)),
                                        ((37, 50), (100, 301)),
                                        ((64, 128), (64, 128)),
                                        ((56, 112), (17, 31))])
def test_nn_resize_equals_jax(small, full):
    x = np.random.RandomState(sum(small)).randint(0, 5, (2, *small))
    want = np.asarray(jax_nn_resize(jnp.asarray(x, jnp.int32), full))
    got = nn_resize_cv2(torch.from_numpy(x).to(torch.int32), full).numpy()
    np.testing.assert_array_equal(got, want)


def _refine_both(road_small, sps, threshold, num_segments):
    want = np.asarray(jdirect.overlaps_refine(
        jnp.asarray(road_small), jnp.asarray(sps), threshold,
        num_segments=num_segments))
    got = tdirect.overlaps_refine(torch.from_numpy(road_small),
                                  torch.from_numpy(sps), threshold,
                                  num_segments).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def test_overlaps_refine_equals_jax():
    """The inputs of tests/test_baselines.py::TestOverlapsRefine (snapping
    to strips, an empty prediction), and random masks on random maps."""
    road_small = np.zeros((1, 4, 4), bool)
    road_small[0, 2:, :2] = True
    sp = np.zeros((1, 16, 16), np.int32)
    for s in range(4):
        sp[0, :, s * 4:(s + 1) * 4] = s
    got = _refine_both(road_small, sp, 0.05, 8)
    assert got[0][:, :8].any() and not got[0][:, 8:].any()
    empty = _refine_both(np.zeros((1, 4, 4), bool),
                         np.zeros((1, 8, 8), np.int32), 0.01, 4)
    assert not empty.any()
    rng = np.random.RandomState(4)
    road = rng.rand(3, 14, 14) < 0.3
    sps = rng.randint(0, 60, (3, 128, 256)).astype(np.int32)
    for threshold in (0.0, 0.01, 0.02):
        _refine_both(road, sps, threshold, 64)


def test_direct_cluster_equals_jax():
    """Feature maps with a distinct lower half; JAX's uniforms injected:
    the assignments are equal (no near-tie on these inputs)."""
    rng = np.random.RandomState(12)
    fmaps = rng.randn(2, 8, 8, 4).astype(np.float32)
    fmaps[:, 5:] += 3.0
    key = jax.random.key(3)
    road, cluster, res = jdirect.direct_cluster(
        jnp.asarray(fmaps), key, k=4, n_iter=100, prior_params=PRIOR)
    unif = torch.from_numpy(np.array(jax.random.uniform(key, (128,))))[None]
    t_road, t_cluster, t_res = tdirect.direct_cluster(
        torch.from_numpy(fmaps), unif, k=4, n_iter=100, prior_params=PRIOR)
    np.testing.assert_array_equal(t_cluster.numpy(), np.asarray(cluster))
    np.testing.assert_array_equal(t_road.numpy(), np.asarray(road))
    assert int(t_res.n_iter[0]) == int(res.n_iter)


def test_direct_generator_matches_jax(weights, scenes):
    """Two groups of B images in one unit, yuv420 wire."""
    variables, sd = weights
    _, imgs, _, _ = scenes
    jcfg = JaxLabelGenConfig(mode="direct", groups_per_dispatch=2, **COMMON)
    jgen = jdirect.make_label_generator(jcfg, variables=variables)
    prep = jgen._host_prepare(imgs, None, JaxStageTimer())
    seeds = np.asarray([11, 22], np.uint32)
    road, cluster, res = jax.device_get(jgen._fused_program()(
        prep["imgs_dev"], seeds, np.int32(4)))
    tgen = tdirect.make_label_generator(
        _port_cfg("direct", groups_per_dispatch=2), state_dict=sd,
        device="cpu")
    assert isinstance(tgen, tdirect.DirectLabelGenerator)
    out = tgen.run_unit(tgen._host_prepare(imgs)["wire"], list(seeds),
                        uniforms=_jax_uniforms(seeds, B * 14 * 14))
    assert out["road"].shape == (2 * B, 14, 14)
    assert (out["road"].numpy() == np.asarray(road)).mean() >= 0.99
    assert (out["cluster"].numpy() == np.asarray(cluster)).mean() >= 0.99
    np.testing.assert_array_equal(out["res"].n_iter.numpy(),
                                  np.asarray(res.n_iter))


def _overlaps_pair(weights, scenes, downscale=1):
    """The JAX and the port's overlaps masks of one batch with the same
    seed and JAX's uniforms, and the port's superpixel maps."""
    variables, sd = weights
    _, imgs, _, full = scenes
    imgs, full = imgs[:B], full[:B]
    jsp = JaxSuperpixelConfig(**dict(SP, slic_device_downscale=downscale))
    jgen = jdirect.make_label_generator(JaxLabelGenConfig(
        mode="overlaps", superpixel=jsp, **COMMON), variables=variables)
    prep = jgen._host_prepare(imgs, full, JaxStageTimer())
    seeds = np.asarray([7], np.uint32)
    road, _, _ = jgen._fused_program()(prep["imgs_dev"], seeds, np.int32(4))
    want, _ = jdirect._refine_packed_program(256, downscale)(
        road, prep["full_sps"], 0.01)
    tsp = tcfg.SuperpixelConfig(**dict(SP, slic_device_downscale=downscale))
    tgen = tdirect.make_label_generator(_port_cfg("overlaps", superpixel=tsp),
                                        state_dict=sd, device="cpu")
    tprep = tgen._host_prepare(imgs, full)
    out = tgen.run_unit(tprep["wire"], list(seeds),
                        uniforms=_jax_uniforms(seeds, B * 14 * 14))
    got, packed = tdirect.refine_and_pack(
        out["road"], tprep["full_sps"], 0.01, 256, downscale)
    return np.asarray(want), got.numpy(), packed.numpy(), tprep


def test_overlaps_generator_matches_jax(weights, scenes):
    want, got, packed, prep = _overlaps_pair(weights, scenes)
    assert got.shape == want.shape == (B, *FULL)
    assert (got == want).mean() >= 0.99
    # the packed download is lossless
    np.testing.assert_array_equal(unpack_mask_bits(packed, FULL[1]), got)
    # masks are unions of the port's own superpixels
    sps = prep["full_sps"].numpy()
    assert sps.shape == (B, *FULL) and prep["sps_upscale"] == 1
    for b in range(B):
        for s in np.unique(sps[b]):
            vals = got[b][sps[b] == s]
            assert vals.all() or not vals.any()
    # the yuv420 wire of the full frames, decoded on the device
    np.testing.assert_array_equal(sps, batched_slic_device_yuv(
        40, 10.0, 3, FULL)(torch.from_numpy(pack_yuv420(
            scenes[3][:B]))).numpy())


def test_overlaps_downscale_gives_block_constant_masks(weights, scenes):
    want, got, packed, prep = _overlaps_pair(weights, scenes, downscale=2)
    assert got.shape == (B, *FULL) and prep["sps_upscale"] == 2
    assert prep["full_sps"].shape == (B, FULL[0] // 2, FULL[1] // 2)
    np.testing.assert_array_equal(got, np.repeat(np.repeat(
        got[:, ::2, ::2], 2, axis=1), 2, axis=2))
    assert (got == want).mean() >= 0.99
    # the packed download carries the half-resolution mask
    np.testing.assert_array_equal(
        unpack_mask_bits(packed, FULL[1] // 2), got[:, ::2, ::2])


def test_process_dataset_both_modes(weights, scenes):
    """The whole host loop: full-resolution masks scored for overlaps,
    feature-resolution ones for direct; run_batch and records."""
    _, sd = weights
    ds, imgs, _, full = scenes
    for mode in ("direct", "overlaps"):
        gen = tdirect.make_label_generator(_port_cfg(mode), state_dict=sd,
                                           device="cpu")
        recs = gen.process_dataset(ds, save=False)
        assert len(recs) == 2 * B
        assert all(np.isfinite(r["road_iou"]) and r["mode"] == mode
                   for r in recs)
        road, cluster, diag, _ = gen.run_batch(imgs[:B], full_images=full[:B])
        assert cluster.shape == (B, 14, 14)
        assert road.shape == ((B, *FULL) if mode == "overlaps"
                              else (B, 14, 14))
        assert diag["kmeans_iters"] >= 1
    assert {"time_superpixel", "time_refine"} <= set(recs[0])
    assert recs[0]["n_superpixels"] == [36] * B
    with pytest.raises(ValueError, match="full-resolution"):
        gen.run_batch(imgs[:B])


@pytest.mark.parametrize("mode,change", [
    ("overlaps", dict(superpixel=tcfg.SuperpixelConfig(method="slic"))),
    ("overlaps", dict(superpixel=tcfg.SuperpixelConfig())),
    ("direct", dict(kmeans=tcfg.KMeansConfig(init="reference"))),
    ("direct", dict(save_images=True)),
])
def test_unported_paths_raise(mode, change):
    cfg = dataclasses.replace(_port_cfg(mode), **change)
    with pytest.raises(NotImplementedError):
        tdirect.make_label_generator(cfg, device="cpu")


def test_generators_run_their_own_mode():
    """Direct runs any superpixel setting (it uses none); a generator
    given another mode's config raises."""
    cfg = _port_cfg("direct", superpixel=tcfg.SuperpixelConfig())
    assert isinstance(tdirect.make_label_generator(cfg, device="cpu"),
                      tdirect.DirectLabelGenerator)
    assert isinstance(tdirect.make_label_generator(
        _port_cfg("spalign"), device="cpu"), SpalignLabelGenerator)
    with pytest.raises(NotImplementedError, match="mode"):
        tdirect.OverlapsLabelGenerator(_port_cfg("direct"), device="cpu")


def test_compute_superpixels_device_slic_only(scenes):
    full = scenes[3][:1]
    maps, counts = compute_superpixels(
        full, tcfg.SuperpixelConfig(**SP), device="cpu")
    assert maps.shape == (1, *FULL) and counts.tolist() == [36]
    with pytest.raises(NotImplementedError):
        compute_superpixels(full, tcfg.SuperpixelConfig(), device="cpu")
    with pytest.raises(NotImplementedError):
        compute_superpixels(full, tcfg.SuperpixelConfig(method="slic"),
                            device="cpu")


CLI = ["--synthetic", "4", "--synthetic_shape", "128", "256",
       "--resize_shape", "112", "112", "--batchsize", "2",
       "--superpixel_method", "slic", "--slic_no_connectivity",
       "--n_slic_segments", "40", "--model_dtype", "float32",
       "--device", "cpu"]


@pytest.mark.parametrize("mode", ["direct", "overlaps"])
def test_cli_runs_and_resumes(mode, tmp_path, capsys):
    out = str(tmp_path / "labels")
    recs = cli.main(CLI + ["--mode", mode, "--out_dir", out])
    assert len(recs) == 4
    assert (tmp_path / "labels" / "result.json").exists()
    summary = (tmp_path / "labels" / "summary.txt").read_text()
    assert "Road mean IoU" in summary and "N\t:4" in summary
    mask = np.load(tmp_path / "labels" / (
        "synthetic_000_000000_leftImg8bit.npy"))
    assert mask.shape == FULL
    assert f"[label_gen] {mode}: n=4" in capsys.readouterr().out
    # every batch done: a resumed run has nothing left to do
    assert cli.main(CLI + ["--mode", mode, "--out_dir", out,
                           "--resume"]) == []


def test_cli_loads_a_pth_checkpoint(tmp_path, monkeypatch):
    """--weights: a .pth state dict saved here goes straight into the
    DRN (its module names are the checkpoints')."""
    model = DRN_FACTORIES["drn_c_26"](
        device="cpu", generator=torch.Generator().manual_seed(9))
    path = tmp_path / "drn_c_26.pth"
    torch.save(model.state_dict(), path)
    seen = {}
    real = tdirect.make_label_generator

    def spy(cfg, state_dict=None, **kw):
        gen = real(cfg, state_dict=state_dict, **kw)
        seen["gen"] = gen
        return gen

    monkeypatch.setattr(tdirect, "make_label_generator", spy)
    cli.main(CLI + ["--mode", "direct", "--synthetic", "2", "--weights",
                    str(path), "--out_dir", str(tmp_path / "o")])
    got = seen["gen"].model.state_dict()
    for name, value in model.state_dict().items():
        assert torch.equal(got[name], value), name


@pytest.mark.parametrize("extra,error", [
    (["--kmeans_init", "reference"], NotImplementedError),
    (["--save_images"], NotImplementedError),
    (["--superpixel_method", "felzenszwalb"], NotImplementedError),
    (["--synthetic", "0", "--cityscapes_dir", "/nonexistent"],
     NotImplementedError),
    (["--weights", "drn.pkl"], NotImplementedError),
])
def test_cli_unported_options_raise(extra, error, tmp_path):
    args = CLI + ["--mode", "overlaps", "--out_dir", str(tmp_path)] + extra
    if "--cityscapes_dir" in extra:
        args = [a for i, a in enumerate(args)
                if a != "--synthetic" and args[i - 1] != "--synthetic"]
    with pytest.raises(error):
        cli.main(args)


def test_cli_defaults_match_jax():
    from spalign_tpu.cli import label_gen as jcli

    got = vars(cli.get_args(["--synthetic", "1"]))
    want = vars(jcli.get_args(["--synthetic", "1"]))
    assert got.pop("device") == "cuda"
    want.pop("profile_dir")
    assert got == want
