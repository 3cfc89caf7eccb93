"""Shared CLI plumbing: dataset construction and weight loading.

Counterpart of ``spalign_tpu/cli/common.py`` with the same flags and
the same dataset sources: synthetic scenes, the Cityscapes image and
label zips, file lists and the Cityscapes directory, read with the
port's PNG reader.
"""

from __future__ import annotations

import argparse

import torch


def add_dataset_args(p: argparse.ArgumentParser):
    p.add_argument("--cityscapes_img_zip", type=str, default=None)
    p.add_argument("--cityscapes_label_zip", type=str, default=None)
    p.add_argument("--img_file_list", type=str, default=None)
    p.add_argument("--label_file_list", type=str, default=None)
    p.add_argument("--cityscapes_dir", type=str, default=None,
                   help="root with leftImg8bit/ + gtFine/")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--synthetic", type=int, default=None,
                   help="use N procedural road scenes (no real data)")
    p.add_argument("--synthetic_shape", type=int, nargs=2,
                   default=[1024, 2048])
    p.add_argument("--synthetic_seed", type=int, default=0)


def build_label_dataset(args, resize_shape):
    """Dataset for label generation: raw uint8 images + full-res labels
    (the precedence of batch_spalign_kmeans.create_dataset :486-521)."""
    from spalign_tpu_torch.data.cityscapes import (
        CityscapesRoadDataset, FileListDataset, ZippedCityscapesRoadDataset)
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

    if args.synthetic is not None:
        return SyntheticRoadScenes(n=args.synthetic,
                                   full_shape=tuple(args.synthetic_shape),
                                   seed=args.synthetic_seed)
    if args.cityscapes_img_zip and args.cityscapes_label_zip:
        return ZippedCityscapesRoadDataset(
            args.cityscapes_img_zip, args.cityscapes_label_zip,
            resize_shape, standardize=False)
    if args.img_file_list:
        return FileListDataset(args.img_file_list, args.label_file_list,
                               resize_shape, standardize=False)
    if args.cityscapes_dir:
        return CityscapesRoadDataset(args.cityscapes_dir, resize_shape,
                                     split=args.split, standardize=False)
    raise SystemExit("no dataset source given (see --help); for a "
                     "data-free demo pass --synthetic N")


def load_drn_weights(args):
    """--weights: a ``.pth`` DRN checkpoint (a state_dict, or a module
    with one), loaded as it is into the port's DRN, whose module names
    are the checkpoints'.  None -> random weights (real label quality
    needs the pretrained checkpoint)."""
    path = getattr(args, "weights", None)
    if not path:
        return None
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"--weights {path}: only .pth checkpoints load into the port; "
            "convert a JAX pytree with spalign_tpu_torch.convert.from_jax")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return state
