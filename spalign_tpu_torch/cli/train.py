"""SegNet training CLI.

Counterpart of ``spalign_tpu/cli/train.py`` with the same flags and
defaults, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).  The train set is the images of
``--train_img_zip`` (a zip or a directory of PNGs) paired with the
estimated labels of ``--train_label_zip`` (a directory, zip or .npz of
.npy masks); the val set is a Cityscapes image and label zip pair,
evaluated at ``--eval_shape``.  ``--resume`` loads one of the port's
``torch.save`` snapshots.  Data-parallel over N devices: one process
per device under ``torchrun --nproc_per_node N ... --num_devices N``
(NCCL on the card, gloo with ``--device cpu``); ``--batchsize`` stays
the global batch, and rank 0 writes the logs and snapshots.

Example:
  python -m spalign_tpu_torch.cli.train \\
      --train_img_zip data/cityscapes_train_imgs.0.zip \\
      --train_label_zip results/estimated_train_labels.0.zip \\
      --val_img_zip data/cityscapes_val_imgs.0.zip \\
      --val_label_zip data/cityscapes_gtFine_val_labels.0.zip \\
      --optimizer Adam --train_limit 2000 --batchsize 8
  torchrun --nproc_per_node 4 -m spalign_tpu_torch.cli.train \\
      --num_devices 4 --result_dir results/train_dp ...
"""

from __future__ import annotations

import argparse
import os
import time

from spalign_tpu_torch.config import TrainConfig


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_img_zip", type=str, required=False,
                   default="data/cityscapes_train_imgs.0.zip")
    p.add_argument("--train_label_zip", type=str, required=False,
                   default="results/estimated_train_labels.0.zip")
    p.add_argument("--val_img_zip", type=str, default=None)
    p.add_argument("--val_label_zip", type=str, default=None)
    p.add_argument("--model", default="basic",
                   choices=["normal", "basic"])
    p.add_argument("--batchsize", type=int, default=8,
                   help="GLOBAL batch (the reference's per-rank batch x "
                        "ranks)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--decay_iteration", type=int, default=300)
    p.add_argument("--weight_decay", type=float, default=0.0005)
    p.add_argument("--train_limit", type=int, default=1000)
    p.add_argument("--optimizer", default="MomentumSGD",
                   choices=["Adam", "MomentumSGD"])
    p.add_argument("--input_shape", type=int, nargs=2, default=[512, 1024])
    p.add_argument("--random", action="store_true", default=False,
                   help="PCA-lighting + horizontal flip augmentation")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--val_interval", type=int, default=50)
    p.add_argument("--eval_shape", type=int, nargs=2, default=[1024, 2048])
    p.add_argument("--result_dir", type=str, default=None,
                   help="explicit result dir; default: timestamped "
                        "<prefix>_<time>_0 (reference create_result_dir)")
    p.add_argument("--prefix", type=str, default="results/train")
    p.add_argument("--use_soft_label", action="store_true", default=False)
    p.add_argument("--use_mse", action="store_true", default=False)
    p.add_argument("--n_use_data", type=int, default=None)
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 runs convs and BN in half precision "
                        "(float32 parameters and optimizer)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without CUDA) or 'cpu'")
    return p.parse_args(argv)


def create_result_dir(prefix: str) -> str:
    """Timestamped, collision-free result directory (the reference's
    create_result_dir, train_segnet.py:97-106)."""
    i = 0
    while True:
        d = f"{prefix}_{time.strftime('%Y-%m-%d_%H-%M-%S')}_{i}"
        if not os.path.exists(d):
            os.makedirs(d)
            return d
        i += 1


def config_from_args(args) -> TrainConfig:
    loss = "soft" if args.use_soft_label else (
        "mse" if args.use_mse else "ce")
    result_dir = args.result_dir or create_result_dir(args.prefix)
    return TrainConfig(
        model=args.model, batchsize=args.batchsize, lr=args.lr,
        decay_iteration=args.decay_iteration,
        weight_decay=args.weight_decay, train_iters=args.train_limit,
        optimizer=args.optimizer, input_shape=tuple(args.input_shape),
        eval_shape=tuple(args.eval_shape), augment=args.random,
        log_interval=args.log_interval, val_interval=args.val_interval,
        loss=loss, n_use_data=args.n_use_data, seed=args.seed,
        result_dir=result_dir, resume=args.resume,
        num_devices=args.num_devices, compute_dtype=args.compute_dtype)


def main(argv=None):
    from spalign_tpu_torch.parallel import dist

    args = get_args(argv)
    dist.setup(args.device)  # joins torchrun's process group
    if args.result_dir is None:
        # one timestamped directory for all ranks, named by rank 0
        args.result_dir = dist.broadcast_object(
            create_result_dir(args.prefix) if dist.rank() == 0 else None)
    cfg = config_from_args(args)

    from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
    from spalign_tpu_torch.data.loader import PrefetchLoader
    from spalign_tpu_torch.train.checkpoints import (SnapshotCallback,
                                                     load_snapshot)
    from spalign_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    soft = cfg.loss in ("soft", "mse")
    train_ds = EstimatedCityscapesDataset(
        args.train_img_zip, args.train_label_zip, cfg.input_shape,
        augment=cfg.augment, use_soft_label=soft, seed=cfg.seed)
    indices = list(range(cfg.n_use_data)) if cfg.n_use_data else None
    loader = PrefetchLoader(train_ds, cfg.batchsize, shuffle=True,
                            seed=cfg.seed, indices=indices,
                            rank=trainer.rank, world=trainer.world)
    print(f"train dataset: {len(train_ds)}")

    evaluator = None
    if args.val_img_zip and args.val_label_zip:
        from spalign_tpu_torch.data.cityscapes import (
            ZippedCityscapesRoadDataset)
        from spalign_tpu_torch.train.evaluator import Evaluator

        val_ds = ZippedCityscapesRoadDataset(
            args.val_img_zip, args.val_label_zip, cfg.input_shape)
        print(f"valid dataset: {len(val_ds)}")

        def val_batches():
            return iter(PrefetchLoader(val_ds, cfg.batchsize,
                                       shuffle=False, epochs=1,
                                       drop_last=False))

        evaluator = Evaluator(trainer.model, val_batches, cfg.eval_shape,
                              device=args.device)

    if cfg.resume:
        trainer.load_state_dict(load_snapshot(cfg.resume,
                                              map_location=trainer.device))
        print(f"resumed from {cfg.resume} at step {trainer.step}")

    trainer.fit(iter(loader), evaluator=evaluator,
                checkpointer=SnapshotCallback(cfg.result_dir))
    print(f"done: {cfg.result_dir}")
    return trainer, evaluator


if __name__ == "__main__":
    from spalign_tpu_torch.parallel import dist

    try:
        main()
    finally:
        dist.close()
