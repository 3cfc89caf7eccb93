"""Trivial 'bottom half = road' baseline CLI (replaces
utils/check_bottom_half_iou.py) -- the sanity lower bound for every
label-generation result.

Counterpart of ``spalign_tpu/cli/bottom_half.py`` with the same flags and
the same printed lines, plus ``--device`` (default ``cuda``): each
image's confusion is counted there, as JAX counts it on its device.
"""

from __future__ import annotations

import argparse

import numpy as np

from spalign_tpu_torch.cli.common import add_dataset_args, build_label_dataset
from spalign_tpu_torch.data.labels import create_label_mask
from spalign_tpu_torch.eval.results import aggregate_results
from spalign_tpu_torch.ops.metrics import segmentation_scores
from spalign_tpu_torch.pipeline.label_gen import _load_batch
from spalign_tpu_torch.utils.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_dataset_args(p)
    p.add_argument("--n_imgs", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    dataset = build_label_dataset(args, (224, 224))
    n = len(dataset) if args.n_imgs is None else min(args.n_imgs,
                                                     len(dataset))
    records = []
    for i in range(n):
        # raw labelIds via the label-gen loading convention
        _, labels = _load_batch(dataset, [i], (224, 224))
        gt = create_label_mask(np.asarray(labels[0]))
        pred = np.zeros_like(gt)
        pred[gt.shape[0] // 2:] = 1
        records.append(segmentation_scores(pred, gt, device=dev))
    agg = aggregate_results(records)
    print(f"bottom-half baseline over {n} images:")
    print(f"  road IoU  : {agg['road_mean_iou']:.4f}")
    print(f"  precision : {agg['precision']:.4f}")
    print(f"  recall    : {agg['recall']:.4f}")
    return agg


if __name__ == "__main__":
    main()
