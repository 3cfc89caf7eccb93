"""Label generation, relabel and a self-training round of the port over
2 gloo CPU ranks (the counterpart of the JAX package's ``mesh=``,
tests/test_sharded_labelgen.py and test_selftrain.py's sharded relabel),
held to the same runs on one rank.

The ranks are spawned once for the module (torch.multiprocessing, a
file:// rendezvous) and run every scenario in one group.  Bars:
  * label generation (spalign with device SLIC, the JAX test's
    configuration at 112^2 and a unit of 2 groups; spalign with
    felzenszwalb, and in the parity mode; direct; overlaps): the JAX
    test's bar, road IoU rtol 1e-6 and TP / FP equal, every other field
    of the records but the host clocks equal, and the saved masks,
    cluster maps and diagnostic panels equal;
  * relabel: the zip's members byte-equal, the records equal, the
    panels equal (7 images in batches of 4: the tail batch is padded);
  * one round: the data-parallel step's bar of tests/test_torch_ddp.py
    on the snapshot (rtol 1e-4 / atol 1e-5; MomentumSGD), then the
    relabel of the two runs' own weights: PREDs equal on >= 0.999 of the
    pixels, mean score difference <= 1e-3.
"""

import dataclasses
import glob
import os
import time
import zipfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spalign_tpu_torch.config import (KMeansConfig, LabelGenConfig,
                                      RoundsConfig, SuperpixelConfig,
                                      TrainConfig)
from spalign_tpu_torch.data.cityscapes import CITYSCAPES_MEAN, CITYSCAPES_STD
from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
from spalign_tpu_torch.data.png import write_png
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.models.segnet import build_segnet
from spalign_tpu_torch.pipeline.direct import make_label_generator
from spalign_tpu_torch.selftrain import NpzShardWriter, RoundsDriver
from spalign_tpu_torch.selftrain.relabel import relabel_dataset
from spalign_tpu_torch.train.checkpoints import find_snapshot, load_snapshot

torch.set_num_threads(2)
WORLD = 2
HW = (32, 64)

SLIC = SuperpixelConfig(method="slic", n_slic_segments=40, slic_iters=3,
                        max_superpixels=128, slic_enforce_connectivity=False)
LABEL_RUNS = {
    # tests/test_sharded_labelgen.py's configuration, with its masks and
    # panels saved
    "spalign_slic": LabelGenConfig(batchsize=8, resize_shape=(112, 112),
                                   superpixel=SLIC, save_images=True),
    # a unit of two groups of 4: rank 0 holds group 0, rank 1 group 1
    "spalign_groups": LabelGenConfig(batchsize=4, groups_per_dispatch=2,
                                     resize_shape=(112, 112),
                                     superpixel=SLIC),
    "spalign_felzenszwalb": LabelGenConfig(
        batchsize=8, resize_shape=(56, 56),
        superpixel=SuperpixelConfig(felzenszwalb_scale=100.0,
                                    max_superpixels=256)),
    # the parity mode (felzenszwalb, float32 DRN): every rank replays
    # the whole group's reference streams
    "spalign_parity": LabelGenConfig(
        batchsize=8, resize_shape=(56, 56),
        superpixel=SuperpixelConfig(felzenszwalb_scale=100.0,
                                    max_superpixels=256),
        kmeans=KMeansConfig(init="reference")),
    "direct": LabelGenConfig(mode="direct", batchsize=8,
                             resize_shape=(56, 56)),
    "overlaps": LabelGenConfig(
        mode="overlaps", batchsize=8, resize_shape=(56, 56),
        superpixel=SuperpixelConfig(method="slic", n_slic_segments=24,
                                    slic_iters=2, max_superpixels=64,
                                    slic_enforce_connectivity=False)),
}
N_RELABEL = 7


class RelabelView:
    """(standardized image, gt in {-1, 0, 1}) at HW, with full images."""

    def __init__(self, n):
        self.ds = SyntheticRoadScenes(n=n, full_shape=HW, seed=13)

    def __len__(self):
        return len(self.ds)

    def image_name(self, i):
        return self.ds.image_name(i)

    def __getitem__(self, i):
        img, lab = self.ds[i]
        img = (img.astype(np.float32) - CITYSCAPES_MEAN) / CITYSCAPES_STD
        return img, (lab == 7).astype(np.int32)

    def full_images(self, indices):
        return [self.ds[i][0] for i in indices]


def _sources(tmp):
    """8 scenes as PNGs and their road masks as the initial label zip."""
    ds = SyntheticRoadScenes(n=8, full_shape=HW, seed=13)
    img_dir = os.path.join(tmp, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    init_zip = os.path.join(tmp, "initial_labels.0.zip")
    w = NpzShardWriter(init_zip)
    for i in range(len(ds)):
        img, lab = ds[i]
        base = os.path.splitext(ds.image_name(i))[0]
        write_png(os.path.join(img_dir, base + ".png"), img)
        w.put(base, lab == 7)
    w.close()
    return img_dir, init_zip


def _scenarios(base, group, sources):
    """Every scenario under ``group`` (None: one rank), outputs under
    ``base``; returns rank 0's records (others: their own) by name."""
    out = {}
    ds = SyntheticRoadScenes(n=8, full_shape=(128, 256), seed=17)
    for name, cfg in LABEL_RUNS.items():
        cfg = dataclasses.replace(cfg, out_dir=os.path.join(base, name))
        gen = make_label_generator(cfg, seed=3, device="cpu", group=group)
        out[name] = gen.process_dataset(ds)
    if group is not None:
        # a unit of 3 images does not split over 2 ranks
        cfg = LabelGenConfig(mode="direct", batchsize=3,
                             resize_shape=(56, 56), save_masks=False)
        try:
            make_label_generator(cfg, device="cpu",
                                 group=group).process_dataset(ds)
        except ValueError as e:
            out["indivisible"] = str(e)
    out["relabel"] = relabel_dataset(
        build_segnet("basic", 2, device="cpu"), None,
        RelabelView(N_RELABEL), os.path.join(base, "relabel.0.zip"),
        eval_shape=HW, batch_size=4, soft_label=True,
        score_dtype=np.float16, out_dir=os.path.join(base, "relabel"),
        save_panels=True, device="cpu")
    img_dir, init_zip = sources
    cfg = RoundsConfig(n_round=1, iteration=2, val_iteration=2,
                       batchsize=4, loss="soft",
                       result_base_dir=os.path.join(base, "rounds"),
                       eval_shape=HW)
    tcfg = TrainConfig(model="basic", optimizer="MomentumSGD", lr=0.1,
                       input_shape=HW, eval_shape=HW)
    out["round"] = RoundsDriver(
        cfg, tcfg,
        lambda src, soft: EstimatedCityscapesDataset(
            img_dir, src or init_zip, HW, use_soft_label=soft),
        lambda: RelabelView(8), device="cpu").run()
    return out


def _rank_main(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=WORLD)
    try:
        out = _scenarios(os.path.join(tmp, "ranks"), dist.group.WORLD,
                         (os.path.join(tmp, "imgs"),
                          os.path.join(tmp, "initial_labels.0.zip")))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(tmp, [rank 0's results, rank 1's], the one-rank results)."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    sources = _sources(tmp)
    ctx = mp.start_processes(_rank_main, args=(tmp,), nprocs=WORLD,
                             join=False, start_method="spawn")
    one = _scenarios(os.path.join(tmp, "one"), None, sources)
    deadline = time.time() + 300
    while not ctx.join(timeout=2):  # raises if a rank failed
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the ranks did not finish within 300 s")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return tmp, ranks, one


def _files(d, pattern="*"):
    return sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(d, pattern)))


@pytest.mark.parametrize("name", list(LABEL_RUNS))
def test_label_generation_two_ranks_equal_one(runs, name):
    tmp, ranks, one = runs
    got, want = ranks[0][name], one[name]
    assert len(got) == len(want) == 8
    assert [r["img_fn"] for r in got] == [r["img_fn"] for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["road_iou"], b["road_iou"], rtol=1e-6)
        assert a["TP"] == b["TP"] and a["FP"] == b["FP"]
        # every other field but the host clocks and the output
        # directory: the unit's superpixel counts and the per-group
        # k-means diagnostics included
        assert sorted(a) == sorted(b)
        for k in b:
            if not k.startswith("time_") and k not in (
                    "elapsed_time", "road_iou", "out_dir"):
                assert a[k] == b[k], k
    # rank 1 returns its own shard's records
    assert ([r["img_fn"] for r in ranks[1][name]]
            == [r["img_fn"] for r in want[4:]])
    d_got = os.path.join(tmp, "ranks", name)
    d_want = os.path.join(tmp, "one", name)
    names = _files(d_want)
    assert names == _files(d_got)
    assert len(_files(d_want, "*.npy")) == 16  # masks and cluster maps
    for fn in names:
        if fn.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(d_got, fn)),
                                          np.load(os.path.join(d_want, fn)))
        elif fn.endswith(".png"):  # diagnostic panels
            with open(os.path.join(d_got, fn), "rb") as f, \
                    open(os.path.join(d_want, fn), "rb") as g:
                assert f.read() == g.read(), fn
    # rank 0 alone wrote result.json, every rank's records in order
    with open(os.path.join(d_got, "result.json")) as f:
        assert f.read().count('"img_fn"') == 8


def test_panels_written_in_the_gt_mode(runs):
    tmp, _, _ = runs
    assert len(_files(os.path.join(tmp, "ranks", "spalign_slic"),
                      "*.png")) == 8
    assert not _files(os.path.join(tmp, "ranks", "direct"), "*.png")


def test_indivisible_unit_refused(runs):
    _, ranks, _ = runs
    for r in ranks:
        assert "not divisible by the 2-device" in r["indivisible"]


def test_relabel_two_ranks_equal_one(runs):
    tmp, ranks, one = runs
    got, want = ranks[0]["relabel"], one["relabel"]
    assert ranks[1]["relabel"] == []
    assert [r["img_fn"] for r in got] == [r["img_fn"] for r in want]
    for a, b in zip(got, want):
        for k in ("road_iou", "TP", "FP", "FN"):
            assert a[k] == b[k]
    with zipfile.ZipFile(os.path.join(tmp, "ranks", "relabel.0.zip")) as zg, \
            zipfile.ZipFile(os.path.join(tmp, "one", "relabel.0.zip")) as zw:
        assert zg.namelist() == zw.namelist()
        assert len(zw.namelist()) == 2 * N_RELABEL
        for m in zw.namelist():
            assert zg.read(m) == zw.read(m), m
    panels = _files(os.path.join(tmp, "one", "relabel"), "*.png")
    assert len(panels) == N_RELABEL
    assert panels == _files(os.path.join(tmp, "ranks", "relabel"), "*.png")
    for fn in panels:
        with open(os.path.join(tmp, "ranks", "relabel", fn), "rb") as f, \
                open(os.path.join(tmp, "one", "relabel", fn), "rb") as g:
            assert f.read() == g.read(), fn


def test_round_two_ranks_equal_one(runs):
    tmp, ranks, one = runs
    (d_got, z_got), (d_want, z_want) = ranks[0]["round"], one["round"]
    assert ranks[1]["round"] == ranks[0]["round"]
    s_got = load_snapshot(find_snapshot(d_got))
    s_want = load_snapshot(find_snapshot(d_want))
    assert s_got["step"] == s_want["step"] == 2
    for k, v in s_want["model"].items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(s_got["model"][k].numpy(),
                                       v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    with np.load(z_got) as g, np.load(z_want) as w:
        assert sorted(g.files) == sorted(w.files)
        preds = [k for k in w.files if not k.endswith("_scores")]
        agree = np.mean([np.mean(g[k] == w[k]) for k in preds])
        assert agree >= 0.999
        diff = np.mean([np.abs(g[k + "_scores"].astype(np.float32)
                               - w[k + "_scores"].astype(np.float32)).mean()
                        for k in preds])
        assert diff <= 1e-3
