"""The port's self-training rounds (spalign_tpu_torch/selftrain/rounds.py,
config.RoundsConfig, cli/rounds.py, cli/relabel.py) on the CPU: twins of
tests/test_selftrain.py's one-device cases, the file layout and
rounds_args.txt held to the JAX package's, and the CLIs on a tiny fake
Cityscapes zip pair.  No tolerances: the checks are on names, layouts,
steps and exact values."""

import dataclasses
import glob
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from spalign_tpu import config as jconfig
from spalign_tpu_torch import config
from spalign_tpu_torch.cli import relabel as relabel_cli
from spalign_tpu_torch.cli import rounds as rounds_cli
from spalign_tpu_torch.config import RoundsConfig, TrainConfig
from spalign_tpu_torch.data.cityscapes import CITYSCAPES_MEAN, CITYSCAPES_STD
from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
from spalign_tpu_torch.data.png import encode_png, write_png
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.selftrain import NpzShardWriter, RoundsDriver
from spalign_tpu_torch.selftrain.rounds import _Subset
from spalign_tpu_torch.train.checkpoints import find_snapshot, load_snapshot

torch.set_num_threads(2)
HW = (32, 64)
N = 8


class RelabelAdapter:
    """(standardized image at input res, full-res gt) + image_name."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def image_name(self, i):
        return self.ds.image_name(i)

    def __getitem__(self, i):
        img, lab = self.ds[i]
        img = (img.astype(np.float32) - CITYSCAPES_MEAN) / CITYSCAPES_STD
        return img, (lab == 7).astype(np.int32)


def setup_sources(tmp_path):
    """N scenes as PNGs in a directory and their road masks (and 0/1
    scores) as the initial label zip."""
    ds = SyntheticRoadScenes(n=N, full_shape=HW, seed=13)
    img_dir = str(tmp_path / "imgs")
    os.makedirs(img_dir)
    init_zip = str(tmp_path / "initial_labels.0.zip")
    w = NpzShardWriter(init_zip)
    for i in range(N):
        img, lab = ds[i]
        base = os.path.splitext(ds.image_name(i))[0]
        write_png(os.path.join(img_dir, base + ".png"), img)
        road = lab == 7
        w.put(base, road)
        w.put(base + "_scores",
              np.stack([1.0 - road, road]).astype(np.float32))
    w.close()
    return ds, img_dir, init_zip


def make_driver(ds, img_dir, init_zip, base, n_round=2, loss="ce",
                iteration=4, batchsize=4, **tkw):
    cfg = RoundsConfig(n_round=n_round, iteration=iteration,
                       val_iteration=iteration, batchsize=batchsize,
                       loss=loss, result_base_dir=base, eval_shape=HW)
    tcfg = TrainConfig(model="basic", optimizer="Adam", input_shape=HW,
                       eval_shape=HW, **tkw)

    def make_train_dataset(label_source, use_soft):
        return EstimatedCityscapesDataset(
            img_dir, label_source or init_zip, HW, use_soft_label=use_soft)

    return RoundsDriver(cfg, tcfg, make_train_dataset,
                        lambda: RelabelAdapter(ds), device="cpu")


def test_two_rounds_end_to_end(tmp_path):
    ds, img_dir, init_zip = setup_sources(tmp_path)
    base = str(tmp_path / "results")
    final_dir, final_zip = make_driver(ds, img_dir, init_zip, base).run()

    r1, r2 = (os.path.join(base, f"train_round{k}") for k in (1, 2))
    assert find_snapshot(r1).endswith("snapshot_iter_4")
    assert find_snapshot(r2).endswith("snapshot_iter_8")
    assert final_dir == r2
    assert final_zip == os.path.join(r2, "iter-8_eval-train.0.zip")
    assert load_snapshot(find_snapshot(r2))["step"] == 8
    for rdir, it in [(r1, 4), (r2, 8)]:
        zf_path = os.path.join(rdir, f"iter-{it}_eval-train.0.zip")
        with zipfile.ZipFile(zf_path) as zf:
            names = zf.namelist()
        # hard-label rounds store only the PRED members
        assert sorted(names) == sorted(
            os.path.splitext(ds.image_name(i))[0] + ".npy"
            for i in range(N))
        with np.load(zf_path) as npz:
            pred = npz[npz.files[0]]
            assert pred.shape == HW and pred.dtype == bool
        with open(os.path.join(rdir, f"iter-{it}_eval-train",
                               "result.json")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["img_fn"] for r in recs] == [ds.image_name(i)
                                               for i in range(N)]
        assert all(0 <= r["road_iou"] <= 1 for r in recs)
        with open(os.path.join(rdir, "args.txt")) as f:
            args = json.load(f)
        assert args["train_iters"] == it and args["loss"] == "ce"
    # round 2 trained on round 1's relabel zip
    d2 = EstimatedCityscapesDataset(
        img_dir, os.path.join(r1, "iter-4_eval-train.0.zip"), HW)
    assert len(d2) == N
    with open(os.path.join(base, "rounds_args.txt")) as f:
        rounds_args = json.load(f)
    assert rounds_args["n_round"] == 2 and rounds_args["eval_shape"] == [
        32, 64]


def test_file_layout_equals_jax(tmp_path):
    """The same two rounds through JAX's driver and the port's write the
    same files (JAX adds its compiled-graph dump), the same zip members,
    the same relabel records' names and the same rounds_args.txt."""
    from spalign_tpu.data.estimated import (
        EstimatedCityscapesDataset as JaxEstimated)
    from spalign_tpu.selftrain import RoundsDriver as JaxDriver

    ds, img_dir, init_zip = setup_sources(tmp_path)
    bases = {k: str(tmp_path / k) for k in ("jax", "port")}
    make_driver(ds, img_dir, init_zip, bases["port"], iteration=2).run()
    JaxDriver(
        jconfig.RoundsConfig(n_round=2, iteration=2, val_iteration=2,
                             batchsize=4, loss="ce",
                             result_base_dir=bases["jax"], eval_shape=HW),
        jconfig.TrainConfig(model="basic", optimizer="Adam",
                            input_shape=HW, eval_shape=HW, num_devices=1),
        lambda src, soft: JaxEstimated(img_dir, src or init_zip, HW,
                                       use_soft_label=soft),
        lambda: RelabelAdapter(ds)).run()

    def layout(base):
        files = {os.path.relpath(p, base) for p in glob.glob(
            os.path.join(base, "**", "*"), recursive=True)
            if os.path.isfile(p)}
        members = {}
        for f in files:
            if f.endswith(".zip"):
                with zipfile.ZipFile(os.path.join(base, f)) as zf:
                    members[f] = sorted(zf.namelist())
        return files, members

    (pf, pm), (jf, jm) = layout(bases["port"]), layout(bases["jax"])
    assert pf <= jf and pm == jm
    assert {os.path.basename(f) for f in jf - pf} == {
        "train_step.stablehlo.txt"}, jf - pf
    for f in pf:
        if f.endswith("result.json"):
            names = [[json.loads(line)["img_fn"]
                      for line in open(os.path.join(bases[k], f))]
                     for k in ("port", "jax")]
            assert names[0] == names[1]
    args = [json.load(open(os.path.join(bases[k], "rounds_args.txt")))
            for k in ("port", "jax")]
    for a in args:
        a.pop("result_base_dir")
    assert args[0] == args[1]


def test_soft_round_reads_round1_scores(tmp_path):
    """Round 1 trains with ce; round 2 with the soft loss on round 1's
    float16 score members, whose channel 1 is 1 - ch0 bit for bit."""
    ds, img_dir, init_zip = setup_sources(tmp_path)
    base = str(tmp_path / "results")
    final_dir, final_zip = make_driver(ds, img_dir, init_zip, base,
                                       loss="soft", iteration=2).run()
    losses = []
    for k in (1, 2):
        with open(os.path.join(base, f"train_round{k}", "args.txt")) as f:
            losses.append(json.load(f)["loss"])
    assert losses == ["ce", "soft"]
    with np.load(final_zip) as npz:
        keys = [k for k in npz.files if k.endswith("_scores")]
        assert len(keys) == N
        for k in keys:
            s = npz[k]
            assert s.dtype == np.float16 and s.shape == (2, *HW)
            want = (1.0 - s[0].astype(np.float32)).astype(np.float16)
            np.testing.assert_array_equal(s[1].view(np.uint16),
                                          want.view(np.uint16))
    r1_zip = os.path.join(base, "train_round1", "iter-2_eval-train.0.zip")
    soft = EstimatedCityscapesDataset(img_dir, r1_zip, HW,
                                      use_soft_label=True)
    assert len(soft) == N and soft[0][1].shape == (*HW, 2)


def test_n_use_data_subsets_training(tmp_path):
    ds, img_dir, init_zip = setup_sources(tmp_path)
    seen = []

    class Spy:
        def __init__(self, base):
            self.base = base

        def __len__(self):
            return len(self.base)

        def __getitem__(self, i):
            seen.append(i)
            return self.base[i]

    driver = make_driver(ds, img_dir, init_zip, str(tmp_path / "results"),
                         n_round=1, iteration=2, batchsize=2, n_use_data=4)
    make = driver.make_train_dataset
    driver.make_train_dataset = lambda *a: Spy(make(*a))
    driver.run()
    assert seen and max(seen) < 4  # only the first n_use_data indices


def test_crash_resume_from_disk_artifacts(tmp_path):
    """Run round 1; resume round 2 with a fresh driver that sees only
    the files on disk (reference --resume_round/--first_result_dir)."""
    ds, img_dir, init_zip = setup_sources(tmp_path)
    base = str(tmp_path / "results")
    make_driver(ds, img_dir, init_zip, base, n_round=1).run()
    r1 = os.path.join(base, "train_round1")
    assert find_snapshot(r1).endswith("snapshot_iter_4")

    final_dir, final_zip = make_driver(ds, img_dir, init_zip, base).run(
        resume_round=2, first_result_dir=r1)
    r2 = os.path.join(base, "train_round2")
    assert final_dir == r2
    state = load_snapshot(find_snapshot(r2))
    assert state["step"] == 8  # continued from round 1's step 4
    # the optimizer state carried over: Adam's step count too
    assert all(int(s["step"]) == 8
               for s in state["optimizer"]["state"].values())
    assert os.path.exists(final_zip)

    with pytest.raises(ValueError, match="first_result_dir"):
        make_driver(ds, img_dir, init_zip, base).run(resume_round=2)
    with pytest.raises(FileNotFoundError):
        make_driver(ds, img_dir, init_zip, base).run(
            resume_round=2, first_result_dir=str(tmp_path / "nope"))


def test_test_mode_caps_data_volumes():
    """Reference --test_mode forces n_use_data=16 / n_labels=16 on top of
    the tiny schedule (run_train_rounds.py:56-61), as JAX's driver does."""
    from spalign_tpu.selftrain import RoundsDriver as JaxDriver

    got = RoundsDriver(RoundsConfig(test_mode=True), TrainConfig(),
                       lambda *a: None, lambda: None, device="cpu")
    want = JaxDriver(jconfig.RoundsConfig(test_mode=True),
                     jconfig.TrainConfig(), lambda *a: None, lambda: None)
    assert got.cfg.n_labels == 16 and got.train_cfg.n_use_data == 16
    assert got.cfg.n_round == 3 and got.cfg.iteration == 10
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    capped = RoundsDriver(RoundsConfig(test_mode=True, n_labels=5),
                          TrainConfig(n_use_data=40), lambda *a: None,
                          lambda: None, device="cpu")
    assert capped.cfg.n_labels == 5 and capped.train_cfg.n_use_data == 16


def test_subset_view_caps_relabel():
    ds = RelabelAdapter(SyntheticRoadScenes(n=N, full_shape=HW, seed=3))
    sub = _Subset(ds, 3)
    assert len(sub) == 3
    assert sub.image_name(1) == ds.image_name(1)
    np.testing.assert_array_equal(sub[2][1], ds[2][1])
    with pytest.raises(IndexError):
        sub[3]
    assert sub.ds is ds.ds  # other attributes forward to the dataset


def test_rounds_config_and_to_json_equal_jax():
    got, want = RoundsConfig(), jconfig.RoundsConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config.to_json(got) == jconfig.to_json(want)
    cfg = dict(n_round=3, loss="mse", eval_shape=(64, 128),
               score_store="eval", input_wire="yuv420")
    assert config.to_json(RoundsConfig(**cfg)) == jconfig.to_json(
        jconfig.RoundsConfig(**cfg))


def test_more_than_one_rank_raises(tmp_path):
    """More devices than the process group has ranks (here: no group)
    raise, naming torchrun, as cli/train.py's do.  (The rounds over more
    than one rank are ported: tests/test_torch_sharded.py.)"""
    ds, img_dir, init_zip = setup_sources(tmp_path)
    driver = make_driver(ds, img_dir, init_zip, str(tmp_path),
                         num_devices=2)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        driver.run()


def _write_zips(tmp_path, ds):
    """A Cityscapes image zip and label zip of ``ds``'s scenes."""
    img_zip, lab_zip = str(tmp_path / "imgs.zip"), str(tmp_path / "labs.zip")
    with zipfile.ZipFile(img_zip, "w") as zi, \
            zipfile.ZipFile(lab_zip, "w") as zl:
        for i in range(len(ds)):
            img, lab = ds[i]
            key = "_".join(ds.image_name(i).split("_")[:3])
            zi.writestr(f"leftImg8bit/train/x/{key}_leftImg8bit.png",
                        encode_png(img))
            zl.writestr(f"gtFine/train/x/{key}_gtFine_labelIds.png",
                        encode_png(lab))
    return img_zip, lab_zip


def test_rounds_and_relabel_clis_test_mode(tmp_path):
    """``cli.rounds --test_mode --device cpu`` (3 rounds of 10 steps, the
    data capped at 16) on a fake zip pair, then ``cli.relabel`` on the
    last round's snapshot in the reference's disk format."""
    ds = SyntheticRoadScenes(n=N, full_shape=(64, 128), seed=21)
    img_zip, lab_zip = _write_zips(tmp_path, ds)
    init = str(tmp_path / "estimated")
    os.makedirs(init)
    for i in range(N):
        np.save(os.path.join(init, os.path.splitext(ds.image_name(i))[0]),
                ds[i][1] == 7)
    base = str(tmp_path / "results")
    final_dir, final_zip = rounds_cli.main([
        "--test_mode", "--device", "cpu", "--use_soft_label",
        "--img_zip", img_zip, "--label_zip", lab_zip,
        "--estimated_label_zip", init, "--batchsize", "4",
        "--input_shape", *map(str, HW), "--eval_shape", "64", "128",
        "--result_base_dir", base])
    assert final_dir == os.path.join(base, "train_round3")
    assert final_zip == os.path.join(final_dir, "iter-30_eval-train.0.zip")
    assert load_snapshot(find_snapshot(final_dir))["step"] == 30
    with np.load(final_zip) as npz:
        assert len(npz.files) == 2 * N
        s = npz[[k for k in npz.files if k.endswith("_scores")][0]]
        # the rounds' store: network resolution, float16
        assert s.shape == (2, *HW) and s.dtype == np.float16

    out = str(tmp_path / "relabel")
    recs = relabel_cli.main([
        "--param_dir", final_dir, "--img_zip_fn", img_zip,
        "--label_zip_fn", lab_zip, "--out_dir", out, "--soft_label",
        "--eval_shape", "64", "128", "--batchsize", "3", "--device",
        "cpu"])
    assert len(recs) == N and all("road_iou" in r for r in recs)
    with np.load(out + ".0.zip") as npz:
        s = npz[[k for k in npz.files if k.endswith("_scores")][0]]
        assert s.shape == (2, 64, 128) and s.dtype == np.float32
    assert len(glob.glob(os.path.join(out, "result.json"))) == 1
