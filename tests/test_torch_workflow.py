"""Real-data rehearsal of the port: the twin of tests/test_workflow_e2e.py.

The README's command sequence (examples/cityscapes_workflow.sh, steps
2-7) through the port's CLIs on the CPU, against a miniature fake
Cityscapes tree written by the port's PNG encoder with Cityscapes file
naming, at the JAX test's small flags: frames 128x256, batch 2,
``--input_shape 64 128``, 4 train steps, ``--n_round 1 --test_mode``
(3 rounds of 10 steps, as the rounds CLI runs it).  The asserts are the
JAX test's, plus: the demo's AVI opens in cv2 with one frame a mask.
"""

import glob
import json
import os
import zipfile

import cv2
import numpy as np
import pytest
import torch

from spalign_tpu_torch.data.png import write_png
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fake_cityscapes(tmp_path_factory):
    """<root>/leftImg8bit/{train,val,demoVideo}/<city>/  +  gtFine/...
    with Cityscapes file naming, rendered from the synthetic scenes."""
    root = tmp_path_factory.mktemp("cityscapes")
    ds = SyntheticRoadScenes(n=8, full_shape=(128, 256), seed=3)
    splits = {"train": ("faketown", range(4)), "val": ("othertown",
                                                       range(4, 6))}
    for split, (city, idxs) in splits.items():
        img_dir = root / "leftImg8bit" / split / city
        lab_dir = root / "gtFine" / split / city
        img_dir.mkdir(parents=True)
        lab_dir.mkdir(parents=True)
        for i in idxs:
            img, lab = ds[i]
            stem = f"{city}_{0:06d}_{i:06d}"
            write_png(str(img_dir / f"{stem}_leftImg8bit.png"), img)
            write_png(str(lab_dir / f"{stem}_gtFine_labelIds.png"), lab)
    demo_dir = root / "leftImg8bit" / "demoVideo" / "stuttgart_00"
    demo_dir.mkdir(parents=True)
    for i in range(6, 8):
        img, _ = ds[i]
        write_png(str(demo_dir / f"frame_{i:06d}.png"), img)
    return root


def test_full_workflow(fake_cityscapes, tmp_path):
    root = str(fake_cityscapes)
    data = tmp_path / "data"
    results = tmp_path / "results"
    data.mkdir()

    # -- step 2: package the dataset as store-only zips ----------------
    from spalign_tpu_torch.cli.make_zips import main as make_zips

    zips = {}
    for name, pattern in [
            ("train_imgs", "leftImg8bit/train/*/*.png"),
            ("train_labels", "gtFine/train/*/*labelIds.png"),
            ("val_imgs", "leftImg8bit/val/*/*.png"),
            ("val_labels", "gtFine/val/*/*labelIds.png")]:
        out = str(data / f"{name}.0.zip")
        make_zips(["dir", os.path.join(root, pattern), out])
        zips[name] = out
    with zipfile.ZipFile(zips["train_imgs"]) as zf:
        assert len(zf.namelist()) == 4

    # -- step 3: sanity lower bound ------------------------------------
    from spalign_tpu_torch.cli.bottom_half import main as bottom_half

    bottom_half(["--cityscapes_img_zip", zips["val_imgs"],
                 "--cityscapes_label_zip", zips["val_labels"],
                 "--device", "cpu"])

    # -- step 4: generate pseudo-labels (random-init DRN), then the
    # summary of their result.json -------------------------------------
    from spalign_tpu_torch.cli.label_gen import main as label_gen
    from spalign_tpu_torch.cli.mean_result import main as mean_result

    est_dir = str(results / "train_labels")
    records = label_gen([
        "--cityscapes_img_zip", zips["train_imgs"],
        "--cityscapes_label_zip", zips["train_labels"],
        "--superpixel_method", "slic", "--n_slic_segments", "40",
        "--max_superpixels", "128", "--resize_shape", "112", "112",
        "--batchsize", "4", "--out_dir", est_dir, "--device", "cpu"])
    assert len(records) == 4
    assert os.path.exists(os.path.join(est_dir, "result.json"))
    masks = [f for f in os.listdir(est_dir)
             if f.endswith(".npy") and "_all_cluster" not in f]
    assert len(masks) == 4  # one mask per train image, image-stem names
    assert all("leftImg8bit" in m for m in masks)
    summary = mean_result([os.path.join(est_dir, "result.json")])
    assert summary["n"] == 4

    # -- step 5: train SegNetBasic on the estimated labels -------------
    from spalign_tpu_torch.cli.train import main as train

    train_dir = str(results / "train")
    train(["--train_img_zip", zips["train_imgs"],
           "--train_label_zip", est_dir,
           "--val_img_zip", zips["val_imgs"],
           "--val_label_zip", zips["val_labels"],
           "--model", "basic", "--optimizer", "Adam", "--batchsize", "2",
           "--train_limit", "4", "--input_shape", "64", "128",
           "--eval_shape", "128", "256", "--val_interval", "4",
           "--log_interval", "2", "--result_dir", train_dir,
           "--device", "cpu"])
    with open(os.path.join(train_dir, "log")) as f:
        log = json.load(f)
    assert any("val/main/iou/road" in rec for rec in log)
    assert glob.glob(os.path.join(train_dir, "snapshot_iter_*"))

    # -- step 6: one self-training round --------------------------------
    from spalign_tpu_torch.cli.rounds import main as rounds

    rounds_dir = str(results / "rounds")
    rounds(["--n_round", "1", "--test_mode", "--iteration", "4",
            "--val_iteration", "4", "--batchsize", "2",
            "--img_zip", zips["train_imgs"],
            "--label_zip", zips["train_labels"],
            "--estimated_label_zip", est_dir,
            "--val_img_zip", zips["val_imgs"],
            "--val_label_zip", zips["val_labels"],
            "--input_shape", "64", "128", "--eval_shape", "128", "256",
            "--result_base_dir", rounds_dir, "--device", "cpu"])
    assert glob.glob(os.path.join(rounds_dir, "*round*"))

    # -- step 7: report + demo video ------------------------------------
    from spalign_tpu_torch.cli.make_table import main as make_table

    csv, _ = make_table([rounds_dir])
    with open(csv) as f:  # a header and a row a round
        assert len(f.read().splitlines()) == 1 + len(
            glob.glob(os.path.join(rounds_dir, "train_round*")))

    from spalign_tpu_torch.cli.demo_video import main as demo_video

    demo_dir = str(results / "demo")
    demo_video(["--param_dir", train_dir,
                "--frames_dir",
                os.path.join(root, "leftImg8bit/demoVideo/stuttgart_00"),
                "--out_dir", demo_dir, "--input_shape", "64", "128",
                "--pred_shape", "128", "256", "--batchsize", "2",
                "--device", "cpu"])
    assert os.path.exists(os.path.join(demo_dir, "demo.avi"))
    assert len(glob.glob(os.path.join(demo_dir, "*.npy"))) == 2

    # the masks the demo wrote are consumable by numpy and binary
    m = np.load(glob.glob(os.path.join(demo_dir, "*.npy"))[0])
    assert m.shape == (128, 256)
    assert set(np.unique(m)) <= {0, 1}
    cap = cv2.VideoCapture(os.path.join(demo_dir, "demo.avi"))
    try:
        assert cap.isOpened()
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 2
    finally:
        cap.release()
