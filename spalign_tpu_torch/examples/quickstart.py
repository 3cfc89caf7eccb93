"""The whole system on synthetic data, through the port's APIs (the
counterpart of ``examples/quickstart.py``):

  1. generate a synthetic Cityscapes-like dataset,
  2. pseudo-label it with the superpixel-align pipeline,
  3. self-train a SegNetBasic on the pseudo-labels for 2 rounds,
  4. report metrics.

Run:  python -m spalign_tpu_torch.examples.quickstart [--device cpu]
      [--workdir DIR] [--images N] [--iterations N]

The defaults are the JAX example's: 8 scenes at 128x256, 20 steps a
round.  ``main`` returns the road IoU of the pseudo-labels and of the
student, and the seconds of each stage.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from spalign_tpu_torch import native
from spalign_tpu_torch.config import (LabelGenConfig, RoundsConfig,
                                      SuperpixelConfig, TrainConfig)
from spalign_tpu_torch.data.cityscapes import CITYSCAPES_MEAN, CITYSCAPES_STD
from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
from spalign_tpu_torch.data.png import write_png
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.eval.results import aggregate_results, read_results
from spalign_tpu_torch.pipeline.direct import make_label_generator
from spalign_tpu_torch.selftrain import RoundsDriver

HW = (64, 128)  # training resolution for the demo
FULL = (128, 256)


class RelabelView:
    """The scenes at the training resolution, standardized, with their
    road ground truth at full resolution."""

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def image_name(self, i):
        return self.scenes.image_name(i)

    def __getitem__(self, i):
        img, lab = self.scenes[i]
        im = native.resize_cubic_u8(img, HW).astype(np.float32)
        im = (im - CITYSCAPES_MEAN) / CITYSCAPES_STD
        return im, (lab == 7).astype(np.int32)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--workdir", default=None)
    p.add_argument("--images", type=int, default=8,
                   help="synthetic scenes (default 8)")
    p.add_argument("--iterations", type=int, default=20,
                   help="training steps a round (default 20)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="spalign_quickstart_")
    print(f"workdir: {workdir}")
    n = args.images
    seconds = {}

    # -- 1. data -----------------------------------------------------------
    scenes = SyntheticRoadScenes(n=n, full_shape=FULL, seed=42)

    # -- 2. pseudo-labels via superpixel-align ------------------------------
    t0 = time.time()
    cfg = LabelGenConfig(
        batchsize=n, resize_shape=(112, 112),
        superpixel=SuperpixelConfig(method="slic", n_slic_segments=60,
                                    slic_iters=5, max_superpixels=256),
        out_dir=os.path.join(workdir, "labels"), save_masks=True)
    gen = make_label_generator(cfg, device=args.device)
    labels = aggregate_results(gen.process_dataset(scenes))
    seconds["labels"] = time.time() - t0
    print(f"pseudo-labels: road IoU {labels['road_mean_iou']:.3f} "
          f"P {labels['precision']:.3f} R {labels['recall']:.3f} "
          f"(random-init DRN)")

    # -- 3. self-train a SegNet on them --------------------------------------
    t0 = time.time()
    img_dir = os.path.join(workdir, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n):
        img, _ = scenes[i]
        base = os.path.splitext(scenes.image_name(i))[0]
        write_png(os.path.join(img_dir, base + ".png"), img)
    it = args.iterations
    rounds = RoundsDriver(
        RoundsConfig(n_round=2, iteration=it, val_iteration=it,
                     batchsize=4, loss="ce",
                     result_base_dir=os.path.join(workdir, "rounds"),
                     eval_shape=FULL),
        TrainConfig(model="basic", optimizer="Adam", input_shape=HW,
                    eval_shape=FULL),
        make_train_dataset=lambda src, use_soft: EstimatedCityscapesDataset(
            img_dir, src or cfg.out_dir, HW, use_soft_label=use_soft),
        make_relabel_dataset=lambda: RelabelView(scenes),
        device=args.device)
    final_dir, final_zip = rounds.run()
    seconds["rounds"] = time.time() - t0
    print(f"self-training done: {final_dir}")
    print(f"round-2 labels: {final_zip}")

    # -- 4. evaluate the final student ----------------------------------------
    student = aggregate_results(read_results(os.path.join(
        final_dir, f"iter-{2 * it}_eval-train", "result.json")))
    print(f"student after 2 rounds: road IoU "
          f"{student['road_mean_iou']:.3f} P {student['precision']:.3f} "
          f"R {student['recall']:.3f}")
    return {"workdir": workdir, "images": n, "iterations": it,
            "label_road_iou": labels["road_mean_iou"],
            "student_road_iou": student["road_mean_iou"],
            "final_zip": final_zip, "seconds": seconds}


if __name__ == "__main__":
    main()
