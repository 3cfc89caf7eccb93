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
which agree on >= 0.995 of the pixels), with the device SLIC frontend
and with the host engines (felzenszwalb maps equal JAX's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.config import KMeansConfig as JaxKMeansConfig
from spalign_tpu.config import LabelGenConfig as JaxLabelGenConfig
from spalign_tpu.config import SuperpixelConfig as JaxSuperpixelConfig
from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu.ops.resize import nn_resize_cv2 as jax_nn_resize
from spalign_tpu.pipeline import direct as jdirect
from spalign_tpu.utils.timers import StageTimer as JaxStageTimer
from spalign_tpu_torch import config as tcfg
from spalign_tpu_torch.cli import label_gen as cli
from spalign_tpu_torch.convert.from_jax import drn_state_dict_from_flax
from spalign_tpu_torch.data.png import decode_png
from spalign_tpu_torch.kernels import slic as tslic
from spalign_tpu_torch.models.drn import DRN_FACTORIES
from spalign_tpu_torch.ops.resize import nn_resize_cv2
from spalign_tpu_torch.pipeline import direct as tdirect
from spalign_tpu_torch.pipeline.label_gen import (SpalignLabelGenerator,
                                                  unpack_mask_bits)
from spalign_tpu_torch.pipeline.superpixels import (batched_slic_device_yuv,
                                                    compute_superpixels)
from spalign_tpu_torch.pipeline.wire import pack_yuv420
from spalign_tpu_torch.utils import viz

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


def _overlaps_pair(weights, scenes, downscale=1, sp=None):
    """The JAX and the port's overlaps masks of one batch with the same
    seed and JAX's uniforms, and the port's superpixel maps.  ``sp``:
    SuperpixelConfig fields (default SP at ``downscale``)."""
    variables, sd = weights
    _, imgs, _, full = scenes
    imgs, full = imgs[:B], full[:B]
    sp = dict(SP, slic_device_downscale=downscale) if sp is None else sp
    max_sp = tcfg.SuperpixelConfig(**sp).max_superpixels
    jgen = jdirect.make_label_generator(JaxLabelGenConfig(
        mode="overlaps", superpixel=JaxSuperpixelConfig(**sp), **COMMON),
        variables=variables)
    prep = jgen._host_prepare(imgs, full, JaxStageTimer())
    seeds = np.asarray([7], np.uint32)
    road, _, _ = jgen._fused_program()(prep["imgs_dev"], seeds, np.int32(4))
    want, _ = jdirect._refine_packed_program(max_sp, downscale)(
        road, prep["full_sps"], 0.01)
    tgen = tdirect.make_label_generator(
        _port_cfg("overlaps", superpixel=tcfg.SuperpixelConfig(**sp)),
        state_dict=sd, device="cpu")
    tprep = tgen._host_prepare(imgs, full)
    out = tgen.run_unit(tprep["wire"], list(seeds),
                        uniforms=_jax_uniforms(seeds, B * 14 * 14))
    got, packed = tdirect.refine_and_pack(
        out["road"], tprep["full_sps"], 0.01, max_sp, downscale)
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


def test_overlaps_slic_config_matches_jax(weights, scenes):
    """bench.py's overlaps_slic superpixels (1024 segments, 5 sweeps,
    max_superpixels 2048, slic_device_downscale 2): K = 1,035 on the
    64x128 half frames, more centres than one TPU block of 1024 holds."""
    sp = dict(method="slic", n_slic_segments=1024, slic_iters=5,
              max_superpixels=2048, slic_enforce_connectivity=False,
              slic_device_downscale=2)
    assert tslic.slic_grid_size(FULL[0] // 2, FULL[1] // 2, 1024) == 1035
    want, got, _, prep = _overlaps_pair(weights, scenes, downscale=2, sp=sp)
    assert got.shape == want.shape == (B, *FULL)
    assert (got == want).mean() >= 0.99
    sps = prep["full_sps"]
    assert sps.shape == (B, FULL[0] // 2, FULL[1] // 2)
    assert int(sps.max()) < 1035 and len(torch.unique(sps[0])) > 900


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
    ("direct", dict(save_images=True)),
    ("overlaps", dict(save_images=True)),
])
def test_unported_paths_raise(mode, change, scenes, tmp_path):
    """save_images raised NotImplementedError in both modes before it was
    ported; it now writes the 2x2 diagnostic panel of each scored image
    under its file name beside the masks (utils/viz.py), as JAX does."""
    ds = scenes[0]
    cfg = dataclasses.replace(_port_cfg(mode), out_dir=str(tmp_path),
                              save_masks=True, **change)
    recs = tdirect.make_label_generator(cfg, device="cpu").process_dataset(
        ds)
    assert len(recs) == len(ds)
    ch, cw = viz.cell_shape(FULL)
    for r in recs:
        with open(tmp_path / r["img_fn"], "rb") as f:
            assert decode_png(f.read()).shape == (
                2 * (viz.TITLE_BAND + ch) + 3 * viz.MARGIN,
                2 * cw + 3 * viz.MARGIN, 3)


@pytest.mark.parametrize("sp", [dict(method="slic"), dict()],
                         ids=["slic_connectivity", "felzenszwalb"])
def test_overlaps_host_engines_match_jax(weights, scenes, sp):
    """The overlaps mode's reference default (felzenszwalb) and SLIC with
    the connectivity pass: maps computed on the host and uploaded, the
    refine at K = max_superpixels; masks agree with JAX's on >= 0.99."""
    want, got, _, prep = _overlaps_pair(weights, scenes, sp=sp)
    assert got.shape == want.shape == (B, *FULL)
    assert (got == want).mean() >= 0.99
    sps = prep["full_sps"].numpy()
    assert prep["sps_upscale"] == 1
    np.testing.assert_array_equal(prep["counts"], sps.max(axis=(1, 2)) + 1)
    for b in range(B):
        for s in np.unique(sps[b]):
            vals = got[b][sps[b] == s]
            assert vals.all() or not vals.any()


def test_direct_parity_init_runs_like_jax(weights, scenes):
    """The direct mode never reads the k-means init: under 'reference' it
    runs as JAX's does (float32 DRN, rgb8 wire, one group a unit)."""
    variables, sd = weights
    ds, imgs, _, _ = scenes
    kw = dict(COMMON, upload_format="rgb8", groups_per_dispatch=2)
    jgen = jdirect.make_label_generator(JaxLabelGenConfig(
        mode="direct", kmeans=JaxKMeansConfig(init="reference"), **kw),
        variables=variables)
    seeds = np.asarray([5], np.uint32)
    prep = jgen._host_prepare(imgs[:B], None, JaxStageTimer())
    road, _, _ = jax.device_get(jgen._fused_program()(
        prep["imgs_dev"], seeds, np.int32(4)))
    tgen = tdirect.make_label_generator(tcfg.LabelGenConfig(
        mode="direct", kmeans=tcfg.KMeansConfig(init="reference"), **kw),
        state_dict=sd, device="cpu")
    assert next(tgen.model.parameters()).dtype == torch.float32
    out = tgen.run_unit(tgen._host_prepare(imgs[:B])["wire"], list(seeds),
                        uniforms=_jax_uniforms(seeds, B * 14 * 14))
    assert (out["road"].numpy() == np.asarray(road)).mean() >= 0.99
    recs = tgen.process_dataset(ds, save=False)
    assert len(recs) == 2 * B
    assert all(isinstance(r["kmeans_iters"], int) for r in recs)


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


@pytest.mark.parametrize("sp", [dict(), dict(method="slic")],
                         ids=["felzenszwalb", "slic_connectivity"])
def test_compute_superpixels_host_engines_equal_jax(scenes, sp):
    """Felzenszwalb maps equal JAX's; SLIC with the connectivity pass
    agrees on >= 0.995 of the pixels (the device SLIC bar)."""
    from spalign_tpu.pipeline.superpixels import \
        compute_superpixels as jax_compute_superpixels

    full = scenes[3][:2]
    maps, counts = compute_superpixels(full, tcfg.SuperpixelConfig(**sp),
                                       device="cpu")
    want, want_counts = jax_compute_superpixels(full,
                                                JaxSuperpixelConfig(**sp))
    assert maps.shape == (2, *FULL) and maps.dtype == np.int32
    if not sp:
        np.testing.assert_array_equal(maps, want)
        np.testing.assert_array_equal(counts, want_counts)
    else:
        assert (maps == want).mean() >= 0.995
    np.testing.assert_array_equal(counts, maps.max(axis=(1, 2)) + 1)


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


@pytest.mark.parametrize("extra", [["--kmeans_init", "reference"],
                                   ["--superpixel_method", "felzenszwalb"]],
                         ids=["parity", "felzenszwalb"])
def test_cli_runs_parity_and_felzenszwalb(extra, tmp_path):
    """The options that raised before: the CLI builds JAX's configuration
    from the same flags and labels every scene."""
    from spalign_tpu.cli import label_gen as jcli
    from spalign_tpu.config import flatten as jax_flatten

    from spalign_tpu_torch.config import flatten

    args = CLI + ["--mode", "overlaps", "--out_dir", str(tmp_path)] + extra
    want = jax_flatten(jcli.config_from_args(jcli.get_args(
        [a for a in args if a not in ("--device", "cpu")])))
    assert flatten(cli.config_from_args(cli.get_args(args))) == want
    recs = cli.main(args)
    assert len(recs) == 4 and all(np.isfinite(r["road_iou"]) for r in recs)


@pytest.mark.parametrize("extra,error", [
    # the JAX converter's pickled pytree does not load into the port
    # (--save_images, which raised here before, is ported)
    (["--weights", "drn_c_26.pytree"], NotImplementedError),
    # the Cityscapes sources are ported: a missing directory raises as
    # the JAX dataset does
    (["--synthetic", "0", "--cityscapes_dir", "/nonexistent"],
     ValueError),
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
    assert got == want
