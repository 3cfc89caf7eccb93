"""Relabel CLI: pseudo-labels from a trained snapshot (counterpart of
``spalign_tpu/cli/relabel.py``, which replaces labels_from_segnet.py).

Same flags, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).  ``--param_dir`` is a training result
directory of the port (its ``args.txt`` and ``torch.save`` snapshots);
images and gt come from a Cityscapes image and label zip pair.  The
predictions go to ``<out_dir>.0.zip`` (or, with ``--save_each``, to
``.npy`` files in ``--out_dir``) and the per-image records to
``<out_dir>/result.json``.  ``--save_panels`` writes the 1x3 panel of
each image into ``--out_dir``.  Under ``torchrun --nproc_per_node N`` each
rank predicts its shard of every batch and rank 0 writes the outputs.

Example:
  python -m spalign_tpu_torch.cli.relabel --param_dir results/train_round1 \\
      --img_zip_fn data/cityscapes_train_imgs.0.zip \\
      --label_zip_fn data/cityscapes_train_labels.0.zip \\
      --out_dir results/relabel --soft_label
"""

from __future__ import annotations

import argparse
import json
import os
import time


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--param_dir", type=str, required=True,
                   help="training result dir (reads its args.txt)")
    p.add_argument("--iteration", type=int, default=None,
                   help="snapshot iteration; latest if omitted")
    p.add_argument("--img_zip_fn", type=str, required=True)
    p.add_argument("--label_zip_fn", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--soft_label", action="store_true", default=False)
    p.add_argument("--eval_shape", type=int, nargs=2,
                   default=[1024, 2048])
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--score_dtype", default="float32",
                   choices=["float32", "float16"],
                   help="on-disk dtype of soft-label scores (float16 "
                        "halves the output zip)")
    p.add_argument("--score_store", default="eval",
                   choices=["eval", "network"],
                   help="resolution of the stored *_scores members: "
                        "'eval' = the reference's disk format (scores "
                        "bilinearly upsampled to eval_shape, "
                        "labels_from_segnet.py:91-95); 'network' keeps the "
                        "network output resolution (the same information, "
                        "a quarter of the bytes at the default shapes; "
                        "the training reader resizes either)")
    p.add_argument("--save_panels", action="store_true", default=False,
                   help="the reference's overlay/GT/prediction panel per "
                        "image (labels_from_segnet.py:97-119): not ported "
                        "yet, raises")
    p.add_argument("--save_each", action="store_true", default=False,
                   help="per-image .npy outputs in out_dir instead of one "
                        "zip (reference run_train_rounds.py:36; its "
                        "pred-as-scores bug is not reproduced)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without CUDA) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the per-image records."""
    import numpy as np

    from spalign_tpu_torch.data.cityscapes import ZippedCityscapesRoadDataset
    from spalign_tpu_torch.models.segnet import build_segnet
    from spalign_tpu_torch.parallel import dist
    from spalign_tpu_torch.selftrain.relabel import relabel_dataset
    from spalign_tpu_torch.train.checkpoints import (find_snapshot,
                                                     load_predictor)

    args = get_args(argv)
    device = dist.setup(args.device)  # joins torchrun's process group
    with open(os.path.join(args.param_dir, "args.txt")) as f:
        train_args = json.load(f)
    model = build_segnet(
        "basic" if train_args.get("model") == "basic" else "normal", 2,
        device=device)
    snapshot = find_snapshot(args.param_dir, args.iteration)
    variables = load_predictor(snapshot)
    print(f"loaded {snapshot}")

    dataset = ZippedCityscapesRoadDataset(
        args.img_zip_fn, args.label_zip_fn,
        tuple(train_args.get("input_shape", [512, 1024])))
    out_zip = args.out_dir.rstrip("/") + ".0.zip"
    t0 = time.time()
    records = relabel_dataset(
        model, variables, dataset, out_zip,
        eval_shape=tuple(args.eval_shape), batch_size=args.batchsize,
        soft_label=args.soft_label, out_dir=args.out_dir,
        score_dtype=getattr(np, args.score_dtype),
        score_store=args.score_store, save_panels=args.save_panels,
        save_each=args.save_each, device=device)
    elapsed = time.time() - t0
    if dist.rank():
        return records
    print(f"wrote {len(records)} predictions to "
          f"{args.out_dir if args.save_each else out_zip} in "
          f"{elapsed:.3f} s ({len(records) / max(elapsed, 1e-9):.3f} "
          f"images/s)")
    return records


if __name__ == "__main__":
    from spalign_tpu_torch.parallel import dist

    try:
        main()
    finally:
        dist.close()
