"""Self-training rounds CLI (counterpart of ``spalign_tpu/cli/rounds.py``,
which replaces utils/run_train_rounds.py).

Same flags, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).  ``--img_zip`` (a Cityscapes image zip,
or a directory of its PNGs for training) pairs with the estimated labels
(a directory, zip or .npz of .npy masks); relabeling reads the
``--img_zip`` / ``--label_zip`` pair.  Under ``torchrun --nproc_per_node
N ... --num_devices N`` each round trains data-parallel and relabels
sharded over the N ranks (``--num_devices`` must be the group's size, as
in ``cli/train.py``).

Example (test mode, like the reference's utils/test.sh smokes):
  python -m spalign_tpu_torch.cli.rounds --test_mode \\
      --img_zip data/cityscapes_train_imgs.0.zip \\
      --label_zip data/cityscapes_train_labels.0.zip \\
      --estimated_label_zip results/estimated_train_labels.0.zip
"""

from __future__ import annotations

import argparse


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_round", type=int, default=1)
    p.add_argument("--iteration", type=int, default=2000)
    p.add_argument("--val_iteration", type=int, default=100)
    p.add_argument("--n_use_data", type=int, default=None)
    p.add_argument("--use_soft_label", action="store_true", default=False)
    p.add_argument("--use_mse", action="store_true", default=False)
    p.add_argument("--random", action="store_true", default=False)
    p.add_argument("--test_mode", action="store_true", default=False)
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--result_base_dir", type=str, default="results")
    p.add_argument("--eval_shape", type=int, nargs=2, default=[1024, 2048])
    p.add_argument("--input_shape", type=int, nargs=2, default=[512, 1024])
    p.add_argument("--img_zip", type=str,
                   default="data/cityscapes_train_imgs.0.zip")
    p.add_argument("--label_zip", type=str,
                   default="data/cityscapes_train_labels.0.zip")
    p.add_argument("--estimated_label_zip", type=str,
                   default="results/estimated_train_labels.0.zip")
    p.add_argument("--val_img_zip", type=str, default=None)
    p.add_argument("--val_label_zip", type=str, default=None)
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 runs the students' convs and BN in "
                        "half precision (float32 parameters)")
    p.add_argument("--score_dtype", default="float16",
                   choices=["float32", "float16"],
                   help="on-disk dtype of soft relabel scores (the "
                        "reference writes float32)")
    p.add_argument("--resume_round", type=int, default=1,
                   help="restart self-training at this round (reference "
                        "run_train_rounds.py:40-45); needs "
                        "--first_result_dir")
    p.add_argument("--first_result_dir", type=str, default=None,
                   help="completed result dir of round resume_round-1")
    p.add_argument("--out_zip_fn", type=str, default=None,
                   help="that round's relabel zip (default: the "
                        "standard name inside first_result_dir)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without CUDA) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Returns (final result dir, final label zip)."""
    args = get_args(argv)

    from spalign_tpu_torch.config import RoundsConfig, TrainConfig
    from spalign_tpu_torch.data.cityscapes import ZippedCityscapesRoadDataset
    from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
    from spalign_tpu_torch.selftrain import RoundsDriver

    loss = "soft" if args.use_soft_label else (
        "mse" if args.use_mse else "ce")
    cfg = RoundsConfig(
        n_round=args.n_round, iteration=args.iteration,
        val_iteration=args.val_iteration, loss=loss, augment=args.random,
        test_mode=args.test_mode, batchsize=args.batchsize,
        result_base_dir=args.result_base_dir,
        eval_shape=tuple(args.eval_shape), score_dtype=args.score_dtype)
    tcfg = TrainConfig(model="basic", optimizer="Adam",
                       input_shape=tuple(args.input_shape),
                       eval_shape=tuple(args.eval_shape),
                       n_use_data=args.n_use_data,
                       num_devices=args.num_devices,
                       compute_dtype=args.compute_dtype)
    input_shape = tuple(args.input_shape)

    def make_train_dataset(label_source, use_soft):
        return EstimatedCityscapesDataset(
            args.img_zip, label_source or args.estimated_label_zip,
            input_shape, augment=args.random, use_soft_label=use_soft)

    class RelabelView:
        """Standardized images at the input resolution + full-resolution
        gt labels."""

        def __init__(self):
            self.d = ZippedCityscapesRoadDataset(
                args.img_zip, args.label_zip, input_shape,
                standardize=True)

        def __len__(self):
            n = len(self.d)
            return min(n, args.n_use_data) if args.n_use_data else n

        def image_name(self, i):
            return self.d.image_name(i)

        def __getitem__(self, i):
            return self.d[i]

    evaluator_factory = None
    if args.val_img_zip and args.val_label_zip:
        from spalign_tpu_torch.data.loader import PrefetchLoader
        from spalign_tpu_torch.train.evaluator import Evaluator

        val_ds = ZippedCityscapesRoadDataset(
            args.val_img_zip, args.val_label_zip, input_shape)

        def evaluator_factory(trainer):
            def val_batches():
                return iter(PrefetchLoader(val_ds, cfg.batchsize,
                                           shuffle=False, epochs=1,
                                           drop_last=False))

            return Evaluator(trainer.model, val_batches, cfg.eval_shape,
                             device=trainer.device)

    driver = RoundsDriver(cfg, tcfg, make_train_dataset,
                          lambda: RelabelView(),
                          evaluator_factory=evaluator_factory,
                          device=args.device)
    final_dir, final_zip = driver.run(
        initial_label_source=None, resume_round=args.resume_round,
        first_result_dir=args.first_result_dir,
        label_zip=args.out_zip_fn)
    print(f"rounds complete: result_dir={final_dir} labels={final_zip}")
    return final_dir, final_zip


if __name__ == "__main__":
    from spalign_tpu_torch.parallel import dist

    try:
        main()
    finally:
        dist.close()
