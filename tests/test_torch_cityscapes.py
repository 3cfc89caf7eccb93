"""The port's Cityscapes readers, estimated-label dataset and CLIs on real
PNG files (spalign_tpu_torch/data/cityscapes.py, data/estimated.py,
cli/common.py, cli/train.py) against the JAX package's, on the CPU.

The cases of tests/test_data.py (pairing, key, remap, missing zip, file
lists, grey and alpha inputs) run against both packages on one fake
Cityscapes tree written by cv2.  Tolerances: names and labels exact;
images within the resize gate of tests/test_torch_png.py (within 1 on
at most 2e-4 of the values), standardized images within one grey level
over the Cityscapes std."""

import json
import os
import zipfile

import cv2
import numpy as np
import pytest
import torch

from spalign_tpu.cli import train as jtrain_cli
from spalign_tpu.data import cityscapes as jcs
from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.cli import label_gen as label_cli
from spalign_tpu_torch.cli import train as train_cli
from spalign_tpu_torch.data import cityscapes as tcs
from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
from spalign_tpu_torch.data.png import decode_png

torch.set_num_threads(2)

N, FULL, HW = 4, (64, 128), (32, 64)
# one grey level of a standardized image
STD_STEP = float(1.0 / tcs.CITYSCAPES_STD.min()) + 1e-4


def _close_u8(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).sum() <= 2e-4 * got.size


def _close_std(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    diff = np.abs(got - want)
    assert diff.max() <= STD_STEP
    assert (diff > 1e-5).sum() <= 2e-4 * got.size


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """<root>/leftImg8bit/train/<city>/..., gtFine/train/<city>/... and
    their two zips, written by cv2 from synthetic scenes."""
    root = tmp_path_factory.mktemp("cityscapes")
    ds = SyntheticRoadScenes(n=N, full_shape=FULL, seed=9)
    img_zip, lab_zip = str(root / "imgs.zip"), str(root / "labels.zip")
    with zipfile.ZipFile(img_zip, "w") as zi, \
            zipfile.ZipFile(lab_zip, "w") as zl:
        for i in range(N):
            img, lab = ds[i]
            city = ("aachen", "bonn")[i % 2]
            key = f"{city}_000000_{i:06d}"
            for sub, name, arr in (
                    ("leftImg8bit", f"{key}_leftImg8bit.png",
                     img[:, :, ::-1]),
                    ("gtFine", f"{key}_gtFine_labelIds.png", lab)):
                d = root / sub / "train" / city
                d.mkdir(parents=True, exist_ok=True)
                assert cv2.imwrite(str(d / name), arr)
                (zi if sub == "leftImg8bit" else zl).write(
                    str(d / name), f"{sub}/train/{city}/{name}")
    return root, img_zip, lab_zip, ds


def _pairs(root, img_zip, lab_zip, standardize):
    kw = dict(standardize=standardize)
    return [
        (tcs.ZippedCityscapesRoadDataset(img_zip, lab_zip, HW, **kw),
         jcs.ZippedCityscapesRoadDataset(img_zip, lab_zip, HW, **kw)),
        (tcs.CityscapesRoadDataset(str(root), HW, split="train", **kw),
         jcs.CityscapesRoadDataset(str(root), HW, split="train", **kw))]


@pytest.mark.parametrize("standardize", [True, False])
def test_pairing_names_and_items_equal_jax(tree, standardize):
    root, img_zip, lab_zip, ds = tree
    for got, want in _pairs(root, img_zip, lab_zip, standardize):
        assert len(got) == len(want) == N
        for i in range(N):
            assert got.image_name(i) == want.image_name(i)
            assert got.label_name(i) == want.label_name(i)
            assert tcs._key(got.image_name(i)) == jcs._key(
                want.image_name(i))
            (gi, gl), (wi, wl) = got[i], want[i]
            np.testing.assert_array_equal(gl, wl)
            assert gl.shape == FULL and set(np.unique(gl)) <= {-1, 0, 1}
            (_close_std if standardize else _close_u8)(
                gi, wi.astype(np.float32))
        # the remap of the labelIds: road 7, void 0..6
        raw = ds[int(got.image_name(0).split("_")[-2])][1]
        np.testing.assert_array_equal(got[0][1] == 1, raw == 7)
        np.testing.assert_array_equal(got[0][1] == -1, raw <= 6)


def test_resized_batch_and_full_images_equal_jax(tree):
    root, img_zip, lab_zip, _ = tree
    for got, want in _pairs(root, img_zip, lab_zip, False):
        gi, gl = got.resized_batch([2, 0, 1], HW)
        wi, wl = want.resized_batch([2, 0, 1], HW)
        assert gi.dtype == np.uint8 and gi.shape == (3,) + HW + (3,)
        _close_u8(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        for a, b in zip(got.full_images([3, 1]), want.full_images([3, 1])):
            np.testing.assert_array_equal(a, b)


def test_missing_zip_raises(tmp_path):
    for mod in (tcs, jcs):
        with pytest.raises(ValueError):
            mod.ZippedCityscapesRoadDataset(str(tmp_path / "nope.zip"),
                                            str(tmp_path / "nope2.zip"),
                                            HW)
        with pytest.raises(ValueError):
            mod.CityscapesRoadDataset(str(tmp_path / "nope"), HW)


def _lists(tmp_path, img_fns, lab_fns=None):
    il = tmp_path / "imgs.txt"
    il.write_text("\n".join(img_fns) + "\n")
    if lab_fns is None:
        return str(il), None
    ll = tmp_path / "labels.txt"
    ll.write_text("\n".join(lab_fns) + "\n")
    return str(il), str(ll)


@pytest.mark.parametrize("with_labels", [True, False])
def test_file_lists_equal_jax(tree, tmp_path, with_labels):
    root, *_ = tree
    img_fns = sorted(str(p) for p in root.glob("leftImg8bit/*/*/*.png"))
    lab_fns = sorted(str(p) for p in root.glob("gtFine/*/*/*.png"))
    il, ll = _lists(tmp_path, img_fns, lab_fns if with_labels else None)
    got = tcs.FileListDataset(il, ll, HW)
    want = jcs.FileListDataset(il, ll, HW)
    assert len(got) == len(want) == N
    for i in range(N):
        assert got.image_name(i) == want.image_name(i)
        assert got.label_name(i) == want.label_name(i)
        (gi, gl), (wi, wl) = got[i], want[i]
        _close_u8(gi, wi)
        if with_labels:
            np.testing.assert_array_equal(gl, wl)
        else:
            assert gl is None and wl is None
    gi, gl = got.resized_batch(range(N), HW)
    wi, wl = want.resized_batch(range(N), HW)
    _close_u8(gi, wi)
    if with_labels:
        np.testing.assert_array_equal(gl, wl)
    else:
        assert gl is None and wl is None


def test_grey_and_alpha_images_normalize_to_3ch(tree, tmp_path):
    """Grey replicates to three channels and alpha drops, as cv2's
    IMREAD_COLOR does (tests/test_data.py)."""
    _, _, _, ds = tree
    img, lab = ds[0]
    grey = cv2.cvtColor(img[:, :, ::-1], cv2.COLOR_BGR2GRAY)
    bgra = cv2.cvtColor(img[:, :, ::-1], cv2.COLOR_BGR2BGRA)
    fns, lfs = [], []
    for name, arr in (("grey", grey), ("bgra", bgra)):
        fn = str(tmp_path / f"{name}.png")
        assert cv2.imwrite(fn, arr)
        fns.append(fn)
        lf = str(tmp_path / f"lab_{name}.png")
        assert cv2.imwrite(lf, lab)
        lfs.append(lf)
    il, ll = _lists(tmp_path, fns, lfs)
    got, want = tcs.FileListDataset(il, ll, HW), jcs.FileListDataset(il, ll,
                                                                     HW)
    g, a = got[0][0], got[1][0]
    assert g.shape == a.shape == HW + (3,)
    np.testing.assert_array_equal(g[..., 0], g[..., 1])
    for i in range(2):
        _close_u8(got[i][0], want[i][0])
        np.testing.assert_array_equal(got[i][1], want[i][1])


@pytest.mark.parametrize("source", ["dir", "zip"])
def test_estimated_dataset_reads_image_sources(tree, tmp_path, source):
    """EstimatedCityscapesDataset over an image zip or directory pairs
    ``<image base name>.npy`` masks, as the JAX class does."""
    from spalign_tpu.data.estimated import (
        EstimatedCityscapesDataset as JaxEstimated)

    root, img_zip, _, ds = tree
    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    for i in range(N - 1):  # one image without a mask
        key = f"{('aachen', 'bonn')[i % 2]}_000000_{i:06d}_leftImg8bit"
        np.save(mask_dir / key, (ds[i][1] == 7).astype(np.uint8))
    src = img_zip if source == "zip" else str(root / "leftImg8bit")
    got = EstimatedCityscapesDataset(src, str(mask_dir), HW)
    want = JaxEstimated(src, str(mask_dir), HW)
    assert len(got) == len(want) == N - 1
    for i in range(N - 1):
        assert os.path.basename(got.image_name(i)) == os.path.basename(
            want.image_name(i))
        (gi, gl), (wi, wl) = got[i], want[i]
        np.testing.assert_array_equal(gl, wl)
        # float resize: torch bicubic against cv2's float cubic
        np.testing.assert_allclose(gi, wi, rtol=0, atol=0.05)
    with pytest.raises(ValueError, match="no image/label pairs"):
        EstimatedCityscapesDataset(src, str(tmp_path), HW)


CLI = ["--resize_shape", "112", "112", "--batchsize", "2",
       "--superpixel_method", "slic", "--slic_no_connectivity",
       "--n_slic_segments", "40", "--model_dtype", "float32",
       "--device", "cpu"]


@pytest.mark.parametrize("source", ["dir", "zip"])
def test_label_cli_reads_cityscapes_sources(tree, tmp_path, source):
    root, img_zip, lab_zip, _ = tree
    src = (["--cityscapes_dir", str(root), "--split", "train"]
           if source == "dir" else
           ["--cityscapes_img_zip", img_zip, "--cityscapes_label_zip",
            lab_zip])
    out = tmp_path / "labels"
    recs = label_cli.main(CLI + src + ["--out_dir", str(out)])
    assert len(recs) == N and all(np.isfinite(r["road_iou"]) for r in recs)
    names = sorted(os.path.basename(r["img_fn"])[:-4] for r in recs)
    for name in names:
        assert np.load(out / f"{name}.npy").shape == FULL
    assert not list(out.glob("*.png"))  # masks as PNG only without GT


def test_label_cli_without_labels_writes_png_masks(tree, tmp_path):
    """No ground truth (an image file list alone): each raw 0/1 mask is
    also written as a PNG under the image's name, equal to its .npy."""
    root, *_ = tree
    img_fns = sorted(str(p) for p in root.glob("leftImg8bit/*/*/*.png"))
    il, _ = _lists(tmp_path, img_fns)
    out = tmp_path / "labels"
    recs = label_cli.main(CLI + ["--img_file_list", il, "--out_dir",
                                 str(out)])
    assert len(recs) == N and "road_iou" not in recs[0]
    for fn in img_fns:
        name = os.path.basename(fn)
        mask = np.load(out / (name[:-4] + ".npy"))
        assert mask.shape == (112, 112) and set(np.unique(mask)) <= {0, 1}
        np.testing.assert_array_equal(
            decode_png((out / name).read_bytes(), color=False), mask)
        np.testing.assert_array_equal(
            cv2.imread(str(out / name), cv2.IMREAD_GRAYSCALE), mask)


def test_train_cli_defaults_match_jax():
    got = vars(train_cli.get_args([]))
    want = vars(jtrain_cli.get_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_train_cli_runs_and_resumes(tree, tmp_path):
    """cli.train on the image zip and an estimated-label directory, with
    the val zips, for 2 steps; then --resume for a third."""
    root, img_zip, lab_zip, ds = tree
    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    for i in range(N):
        key = f"{('aachen', 'bonn')[i % 2]}_000000_{i:06d}_leftImg8bit"
        np.save(mask_dir / key, (ds[i][1] == 7).astype(np.uint8))
    common = ["--train_img_zip", img_zip, "--train_label_zip",
              str(mask_dir), "--val_img_zip", img_zip, "--val_label_zip",
              lab_zip, "--batchsize", "2", "--input_shape", "32", "64",
              "--eval_shape", "64", "128", "--optimizer", "Adam",
              "--log_interval", "1", "--val_interval", "2",
              "--device", "cpu"]
    run1 = tmp_path / "run1"
    trainer, evaluator = train_cli.main(
        common + ["--train_limit", "2", "--result_dir", str(run1)])
    assert trainer.step == 2 and evaluator is not None
    snap = run1 / "snapshot_iter_2"
    assert snap.exists()
    with open(run1 / "log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [r["iteration"] for r in log if "main/loss" in r] == [1, 2]
    assert any("val/main/iou/road" in r for r in log)
    assert all(np.isfinite(r["main/loss"]) for r in log if "main/loss" in r)

    run2 = tmp_path / "run2"
    trainer2, _ = train_cli.main(
        common + ["--train_limit", "3", "--result_dir", str(run2),
                  "--resume", str(snap)])
    assert trainer2.step == 3
    assert (run2 / "snapshot_iter_3").exists()


def test_train_cli_one_card_only(tmp_path):
    """Outside a process group of 2 ranks, --num_devices 2 raises and
    names the launcher (the CLI under torchrun: tests/test_torch_ddp.py
    holds the data-parallel step)."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train_cli.main(["--num_devices", "2", "--device", "cpu",
                        "--result_dir", str(tmp_path)])
