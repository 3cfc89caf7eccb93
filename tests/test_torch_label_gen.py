"""The port's fused-SLIC label generator (spalign_tpu_torch/pipeline/
label_gen.py) against the JAX package's, on the CPU.

Both run the same configuration (float32 DRN-C-26 at full width with
bridged weights, yuv420 wire, 112x112, 2 groups of 3 images, 40 SLIC
segments, 4 sweeps) and the port gets the JAX package's random draws,
rebuilt here as ``_align_and_prior`` makes them.  Tolerances: cluster
maps agree on >= 0.99 of pixels (see the test for the one known source
of difference); road IoU of a whole run within 0.1 with the port's own
draws; scoring exact.  The host superpixel engines and the parity mode
run on the rgb8 wire and agree with JAX on >= 0.99 of the pixels too
(test_host_paths_run_like_jax)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from spalign_tpu.config import LabelGenConfig as JaxLabelGenConfig
from spalign_tpu.config import SuperpixelConfig as JaxSuperpixelConfig
from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu.kernels.slic import slic as jax_slic
from spalign_tpu.kernels.slic import slic_grid_size as jax_grid_size
from spalign_tpu.pipeline import label_gen as jlg
from spalign_tpu.pipeline.wire import decode_yuv420 as jax_decode
from spalign_tpu.utils.timers import StageTimer as JaxStageTimer
from spalign_tpu_torch import config as tcfg
from spalign_tpu_torch.convert.from_jax import drn_state_dict_from_flax
from spalign_tpu_torch.ops.segments import anchor_key_bits
from spalign_tpu_torch.pipeline import label_gen as tlg

torch.set_num_threads(2)

HW = (112, 112)
B, G = 3, 2
COMMON = dict(batchsize=B, resize_shape=HW, groups_per_dispatch=G,
              model_dtype="float32", upload_format="yuv420",
              save_masks=False)
SP = dict(method="slic", n_slic_segments=40, slic_iters=4,
          max_superpixels=128, slic_enforce_connectivity=False)


def _port_cfg(**kw):
    base = dict(COMMON, superpixel=tcfg.SuperpixelConfig(**SP))
    base.update(kw)
    return tcfg.LabelGenConfig(**base)


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxLabelGenConfig(superpixel=JaxSuperpixelConfig(**SP),
                             **COMMON)
    jgen = jlg.SpalignLabelGenerator(jcfg, seed=777)
    sd = drn_state_dict_from_flax(jax.device_get(jgen.variables))
    tgen = tlg.SpalignLabelGenerator(_port_cfg(), state_dict=sd, seed=777,
                                     device="cpu")
    ds = SyntheticRoadScenes(n=B * G, full_shape=(128, 256), seed=9)
    return jgen, tgen, sd, ds


def _jax_draws(seeds, hw, s):
    """The anchor bits and seeding uniforms of jlg._align_and_prior."""
    avail = anchor_key_bits(s)
    bits, unif = [], []
    for seed in seeds:
        k_align, k_seed = jax.random.split(jax.random.key(seed))
        for k in jax.random.split(k_align, B):
            bits.append(np.array(jax.random.randint(
                k, (hw,), 0, 2 ** avail, dtype=jnp.int32)))
        unif.append(np.array(jax.random.uniform(k_seed, (B * s,))))
    return tlg.UnitDraws(torch.from_numpy(np.stack(bits)),
                         torch.from_numpy(np.stack(unif)))


def test_unit_matches_jax_with_its_draws(pair):
    jgen, tgen, _, ds = pair
    imgs, _ = ds.resized_batch(range(B * G), HW)
    seeds = np.asarray([11, 22], np.uint32)
    prep = jgen._host_prepare(imgs, None, None)
    road, packed, cluster, assign, res, ok = jax.device_get(
        jgen._fused_program()(prep["imgs_dev"], seeds, np.int32(4)))

    wire = tgen._host_prepare(imgs)["wire"]
    out = tgen.run_unit(wire, list(seeds),
                        draws=_jax_draws(seeds, HW[0] * HW[1],
                                         tgen.num_segments))
    # The port's superpixels equal JAX's standalone dense SLIC sweep.
    # Inside JAX's fused program XLA fuses that sweep with the rest and
    # may resolve a near-tie differently (one pixel on this input): the
    # only source of cluster-map differences here.
    dense = np.asarray(jax.vmap(lambda im: jax_slic(
        im, n_segments=40, n_iter=4))(jax_decode(prep["imgs_dev"], HW)))
    assert (out["superpixels"].numpy() == dense).mean() > 0.995
    assert (out["cluster"].numpy() == np.asarray(cluster)).mean() >= 0.99
    assert (out["road"].numpy() == np.asarray(road)).mean() >= 0.99
    np.testing.assert_array_equal(out["ok"].numpy(), np.asarray(ok))
    np.testing.assert_array_equal(out["res"].n_iter.numpy(),
                                  np.asarray(res.n_iter))
    assert tgen.num_segments == int(prep["counts"][0])


def test_process_dataset_quality_close_to_jax(pair):
    jgen, tgen, _, ds = pair
    jrec = jgen.process_dataset(ds, save=False)
    trec = tgen.process_dataset(ds, save=False)
    assert len(trec) == len(jrec) == B * G
    j_iou = np.mean([r["road_iou"] for r in jrec])
    t_iou = np.mean([r["road_iou"] for r in trec])
    assert abs(j_iou - t_iou) < 0.1, (j_iou, t_iou)
    for r in trec:
        assert np.isfinite(r["road_iou"])
        assert {"img_fn", "label_fn", "TP", "FP", "FN", "kmeans_iters",
                "kmeans_converged", "retries", "elapsed_time",
                "superpixel.n_slic_segments"} <= set(r)


@pytest.mark.parametrize("small,full", [((112, 112), (256, 512)),
                                        ((28, 28), (1024, 2048)),
                                        ((37, 50), (100, 301))])
def test_scoring_equals_jax_host_confusion(small, full):
    rng = np.random.RandomState(sum(small))
    mask = rng.rand(*small) < 0.4
    label_ids = rng.randint(0, 34, full).astype(np.uint8)
    label_ids[rng.rand(*full) < 0.3] = 7
    got = tlg.host_confusion(mask, label_ids)
    want = jlg.host_confusion(mask, label_ids)
    np.testing.assert_array_equal(got, want)
    assert tlg._confusion_record(got) == jlg._confusion_record(want)


def test_tail_batches_overlap_like_jax(pair):
    """n=7, batchsize 3: [0:3], [3:6], [4:7] — the reference's
    keep-the-batchsize tail (the same rule as the JAX loop)."""
    *_, sd, _ = pair
    assert tlg.batch_slices(0, 7, 3) == [(0, 3), (3, 6), (4, 7)]
    assert tlg.batch_slices(2, 4, 3) == [(2, 4)]
    scenes = SyntheticRoadScenes(n=7, full_shape=(128, 256), seed=3)

    class Pairs:  # (image, labelIds) items only: the loader resizes
        def __len__(self):
            return len(scenes)

        def __getitem__(self, i):
            return scenes[i]

    gen = tlg.SpalignLabelGenerator(_port_cfg(groups_per_dispatch=1),
                                    state_dict=sd, device="cpu")
    recs = gen.process_dataset(Pairs(), save=False, prefetch=2)
    assert len(recs) == 9
    assert len({r["img_fn"] for r in recs}) == 7
    assert all(np.isfinite(r["road_iou"]) for r in recs)


def test_retry_reruns_the_unit(pair, monkeypatch):
    """A group with an all-empty road mask re-runs the unit with fresh
    seeds, at most max_retries runs in all."""
    *_, sd, ds = pair
    gen = tlg.SpalignLabelGenerator(_port_cfg(), state_dict=sd,
                                    device="cpu")
    calls = []
    real = gen.run_unit

    def fake(wire, seeds, draws=None, sps=None):
        out = real(wire, seeds, draws, sps)
        calls.append(list(seeds))
        if len(calls) == 1:
            out["ok"] = torch.zeros_like(out["ok"])
        return out

    monkeypatch.setattr(gen, "run_unit", fake)
    recs = gen.process_dataset(ds, save=False)
    assert len(calls) == 2 and calls[0] != calls[1]
    assert all(r["retries"] == 1 for r in recs)


def test_masks_saved_at_label_resolution(pair, tmp_path):
    *_, sd, ds = pair
    cfg = _port_cfg(out_dir=str(tmp_path), save_masks=True)
    gen = tlg.SpalignLabelGenerator(cfg, state_dict=sd, device="cpu")
    gen.process_dataset(ds)
    m = np.load(tmp_path / (ds.image_name(0)[:-4] + ".npy"))
    c = np.load(tmp_path / (ds.image_name(0)[:-4] + "_all_cluster.npy"))
    assert m.shape == c.shape == (128, 256) and m.dtype == np.uint8
    assert set(np.unique(m)) <= {0, 1}
    np.testing.assert_array_equal(m, (c == 0).astype(np.uint8))
    assert (tmp_path / "result.json").exists()



class _ImagesOnly:
    """A dataset without ground truth: items are bare images."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i][0]

    def image_name(self, i):
        return self.ds.image_name(i)


def test_no_gt_run_writes_png_masks(pair, tmp_path):
    """Without labels each raw 0/1 mask is also written as a PNG under
    the image's file name (JAX label_gen.py:727-736), equal to its
    .npy."""
    import cv2

    from spalign_tpu_torch.data.png import decode_png

    *_, sd, ds = pair
    cfg = _port_cfg(out_dir=str(tmp_path), save_masks=True)
    gen = tlg.SpalignLabelGenerator(cfg, state_dict=sd, device="cpu")
    recs = gen.process_dataset(_ImagesOnly(ds))
    assert len(recs) == len(ds) and "road_iou" not in recs[0]
    for i in range(len(ds)):
        name = ds.image_name(i)
        mask = np.load(tmp_path / (name[:-4] + ".npy"))
        assert mask.shape == HW
        np.testing.assert_array_equal(
            decode_png((tmp_path / name).read_bytes(), color=False), mask)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / name), cv2.IMREAD_GRAYSCALE), mask)

def test_downscaled_superpixels_run(pair):
    """slic_device_downscale=2: SLIC and everything after the superpixel
    map at 56x56, the DRN at 112x112."""
    *_, sd, ds = pair
    cfg = _port_cfg(superpixel=tcfg.SuperpixelConfig(
        **dict(SP, slic_device_downscale=2)))
    gen = tlg.SpalignLabelGenerator(cfg, state_dict=sd, device="cpu")
    road, cluster, diag, _ = gen.run_batch(
        ds.resized_batch(range(B), HW)[0])
    assert road.shape == (B, 56, 56)
    assert gen.num_segments == jax_grid_size(56, 56, 40)
    assert diag["kmeans_iters"] >= 1


@pytest.mark.parametrize("change", [
    dict(mode="direct"),
    # the parity mode over a process group (here a one-rank gloo group),
    # refused here until it sharded: it now runs, equal to no group
    # (2 ranks: tests/test_torch_sharded.py).  (save_images, which
    # raised here before that, is ported: tests/test_torch_diagnostics.py)
    dict(kmeans=tcfg.KMeansConfig(init="reference"), upload_format="rgb8")])
def test_unported_paths_raise(change, tmp_path, pair):
    cfg = dataclasses.replace(_port_cfg(), **change)
    if "mode" in change:
        with pytest.raises(NotImplementedError):
            tlg.SpalignLabelGenerator(cfg, device="cpu")
        return
    *_, sd, ds = pair
    imgs = ds.resized_batch(range(B), HW)[0]
    want = tlg.SpalignLabelGenerator(cfg, state_dict=sd,
                                     device="cpu").run_batch(imgs)
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                             rank=0, world_size=1)
    try:
        got = tlg.SpalignLabelGenerator(
            cfg, state_dict=sd, device="cpu",
            group=tdist.group.WORLD).run_batch(imgs)
    finally:
        tdist.destroy_process_group()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]


def _to_jax(cfg):
    """The JAX package's LabelGenConfig with the port config's fields."""
    import spalign_tpu.config as jconfig

    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(jconfig, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return jconfig.LabelGenConfig(**kw)


@pytest.mark.parametrize("change", [
    dict(kmeans=tcfg.KMeansConfig(init="reference")),
    dict(superpixel=tcfg.SuperpixelConfig()),
    dict(superpixel=tcfg.SuperpixelConfig(
        **dict(SP, slic_enforce_connectivity=True))),
], ids=["parity", "felzenszwalb", "slic_connectivity"])
def test_host_paths_run_like_jax(pair, change):
    """The parity mode and the host superpixel engines, on the rgb8 wire
    (both packages refuse yuv420 for them), one group of B images.  The
    parity mode replays the same streams from the same seed; the host
    engines get JAX's draws at K = max_superpixels.  Cluster and road
    maps agree on >= 0.99 of the pixels (float rounding of the DRN)."""
    jgen0, _, sd, ds = pair
    cfg = dataclasses.replace(_port_cfg(upload_format="rgb8",
                                        groups_per_dispatch=1), **change)
    jgen = jlg.SpalignLabelGenerator(_to_jax(cfg),
                                     variables=jgen0.variables, seed=777)
    tgen = tlg.SpalignLabelGenerator(cfg, state_dict=sd, seed=777,
                                     device="cpu")
    imgs, _ = ds.resized_batch(range(B), HW)
    if cfg.kmeans.init == "reference":
        road, cluster, diag, _ = jgen.run_batch(imgs)
        t_road, t_cluster, t_diag, _ = tgen.run_batch(imgs)
        assert t_diag["n_superpixels"] == diag["n_superpixels"]
        assert t_diag["kmeans_iters"] >= 1
    else:
        seeds = np.asarray([11], np.uint32)
        prep = jgen._host_prepare(imgs, None, JaxStageTimer())
        road, _, cluster, _, res, ok = jax.device_get(jgen._fused_program()(
            prep["imgs_dev"], prep["sps_dev"], seeds, np.int32(4)))
        tprep = tgen._host_prepare(imgs)
        assert tgen.num_segments == cfg.superpixel.max_superpixels
        assert (tprep["sps_host"] == prep["sps_host"]).mean() >= 0.995
        out = tgen.run_unit(tprep["wire"], list(seeds),
                            draws=_jax_draws(seeds, HW[0] * HW[1],
                                             tgen.num_segments),
                            sps=tprep["sps"])
        t_road, t_cluster = out["road"], out["cluster"]
        np.testing.assert_array_equal(out["ok"].numpy(), np.asarray(ok))
    assert (t_cluster.numpy() == np.asarray(cluster)).mean() >= 0.99
    assert (t_road.numpy() == np.asarray(road)).mean() >= 0.99


def test_spalign_cluster_equals_jax():
    """One clustering group on given feature maps and superpixel maps:
    align + prior + k-means + paint, with JAX's draws."""
    rng = np.random.RandomState(12)
    b, s = 2, 36
    sps = np.stack([np.repeat(np.repeat(
        rng.permutation(s).reshape(6, 6), 8, 0), 8, 1)
        for _ in range(b)]).astype(np.int32)  # (2, 48, 48)
    fmaps = rng.randn(b, 12, 12, 8).astype(np.float32)
    fmaps[:, 6:] += 3.0  # a lower half that differs, like a road
    params = (0.75, 0.5, 0.1, 0.1)
    kw = dict(n_anchors=10, num_segments=s, append_pos=True, k=4,
              n_iter=1000, prior_params=params)
    road, cluster, assign, res = jlg.spalign_cluster(
        jnp.asarray(fmaps), jnp.asarray(sps), jax.random.key(3), **kw)
    avail = anchor_key_bits(s)
    k_align, k_seed = jax.random.split(jax.random.key(3))
    bits = np.stack([np.array(jax.random.randint(
        k, (48 * 48,), 0, 2 ** avail, dtype=jnp.int32))
        for k in jax.random.split(k_align, b)])
    unif = np.array(jax.random.uniform(k_seed, (b * s,)))[None]
    t_road, t_cluster, t_assign, t_res = tlg.spalign_cluster(
        torch.from_numpy(fmaps), torch.from_numpy(sps),
        tlg.UnitDraws(torch.from_numpy(bits), torch.from_numpy(unif)), **kw)
    np.testing.assert_array_equal(t_assign.numpy(), np.asarray(assign))
    np.testing.assert_array_equal(t_cluster.numpy(), np.asarray(cluster))
    np.testing.assert_array_equal(t_road.numpy(), np.asarray(road))
    assert int(t_res.n_iter[0]) == int(res.n_iter)
