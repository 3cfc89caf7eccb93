"""Multi-round self-training driver, in-process (counterpart of
``spalign_tpu/selftrain/rounds.py``).

Reference: utils/run_train_rounds.py, a shell and process orchestra (an
mpiexec subprocess per round, a pool of GPU workers and a writer process
for relabeling).  Here every round runs in one process on one device:
train -> relabel (batched inference, streamed zip) -> retrain, resuming
the whole optimizer state from the previous round's snapshot with the
iteration budget extended by ``iteration`` a round (the reference's
resume semantics, run_train_rounds.py:277-295).  Under ``torchrun``
every rank runs the driver: each round trains data-parallel
(``train/trainer.py``) and relabels sharded (``selftrain/relabel.py``);
a barrier follows, then every rank reads the new zip, as the JAX
package relabels on the trainer's mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np

from spalign_tpu_torch.config import RoundsConfig, TrainConfig, to_json
from spalign_tpu_torch.data.loader import PrefetchLoader
from spalign_tpu_torch.parallel import dist as pdist
from spalign_tpu_torch.selftrain.relabel import relabel_dataset
from spalign_tpu_torch.train.checkpoints import (SnapshotCallback,
                                                 find_snapshot,
                                                 load_snapshot)
from spalign_tpu_torch.train.trainer import Trainer


class RoundsDriver:
    """Orchestrates n_round train -> relabel cycles.

    Datasets come from factories, so that each round can rebind the label
    source to the previous round's output:

      make_train_dataset(label_source: str | None, use_soft: bool) ->
          the training dataset (label_source None: the initial estimated
          labels)
      make_relabel_dataset() -> the relabel dataset (images at the input
          resolution, gt at eval_shape for the records)
      make_val_batches: accepted for the JAX signature; evaluation goes
          through ``evaluator_factory(trainer)``

    The loss schedule is the reference's: round 1 trains with hard
    cross-entropy on the initial estimated labels (run_train_rounds.py
    start_first_round passes no soft flag, :83-120); the configured
    soft or MSE loss applies from round 2, whose relabel zips carry score
    members.

    device: 'cuda' (default; raises without CUDA) or 'cpu'.  Under a
    process group every rank constructs the driver with the same
    arguments; ``train_cfg.num_devices`` must be the group's size (None:
    whatever it is), as the Trainer checks.
    """

    def __init__(self, cfg: RoundsConfig, train_cfg: TrainConfig,
                 make_train_dataset: Callable,
                 make_relabel_dataset: Callable,
                 make_val_batches: Optional[Callable] = None,
                 evaluator_factory: Optional[Callable] = None,
                 device="cuda"):
        self.device = pdist.setup(device)  # under torchrun: joins its group
        if cfg.test_mode:
            # reference --test_mode caps the data volumes too, not just
            # the schedule (run_train_rounds.py:56-61: n_use_data=16,
            # n_labels=16)
            cfg = dataclasses.replace(
                cfg, iteration=10, val_iteration=10, n_round=3,
                n_labels=16 if cfg.n_labels is None else min(
                    cfg.n_labels, 16))
            train_cfg = dataclasses.replace(
                train_cfg, n_use_data=16 if train_cfg.n_use_data is None
                else min(train_cfg.n_use_data, 16))
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.make_train_dataset = make_train_dataset
        self.make_relabel_dataset = make_relabel_dataset
        self.make_val_batches = make_val_batches
        self.evaluator_factory = evaluator_factory
        self.round_dirs = []

    def _round_dir(self, n_round: int) -> str:
        return os.path.join(self.cfg.result_base_dir,
                            f"train_round{n_round}")

    def _round_zip(self, n_round: int, result_dir: str) -> str:
        iteration = self.cfg.iteration * n_round
        return os.path.join(result_dir,
                            f"iter-{iteration}_eval-train.0.zip")

    def _train_round(self, n_round: int, label_source: Optional[str],
                     resume_state=None) -> str:
        cfg = self.cfg
        result_dir = self._round_dir(n_round)
        # round 1 = hard CE on the initial estimated labels (they carry
        # no scores); soft/mse from round 2 (the reference's schedule)
        round_loss = "ce" if n_round == 1 else cfg.loss
        tc = dataclasses.replace(
            self.train_cfg,
            train_iters=cfg.iteration * n_round,
            val_interval=cfg.val_iteration,
            log_interval=cfg.val_iteration,
            loss=round_loss,
            augment=cfg.augment,
            batchsize=cfg.batchsize,
            eval_shape=cfg.eval_shape,
            result_dir=result_dir)
        trainer = Trainer(tc, device=self.device)
        if resume_state is not None:
            trainer.load_state_dict(resume_state)
        dataset = self.make_train_dataset(
            label_source, round_loss in ("soft", "mse"))
        indices = (list(range(min(tc.n_use_data, len(dataset))))
                   if tc.n_use_data else None)
        batches = iter(PrefetchLoader(dataset, tc.batchsize, shuffle=True,
                                      seed=tc.seed + n_round,
                                      indices=indices, rank=trainer.rank,
                                      world=trainer.world))
        evaluator = (self.evaluator_factory(trainer)
                     if self.evaluator_factory is not None else None)
        try:
            trainer.fit(batches, evaluator=evaluator,
                        checkpointer=SnapshotCallback(result_dir))
        finally:
            batches.close()  # stops the loader's producer thread
        self.round_dirs.append(result_dir)
        self._last_trainer = trainer
        return result_dir

    def _relabel(self, n_round: int, result_dir: str) -> str:
        cfg = self.cfg
        out_zip = self._round_zip(n_round, result_dir)
        dataset = self.make_relabel_dataset()
        if cfg.n_labels is not None:
            dataset = _Subset(dataset, cfg.n_labels)
        relabel_dataset(
            self._last_trainer.model, None, dataset, out_zip,
            eval_shape=cfg.eval_shape, batch_size=cfg.batchsize,
            soft_label=cfg.loss in ("soft", "mse"),
            score_dtype=np.dtype(cfg.score_dtype),
            score_store=cfg.score_store, input_wire=cfg.input_wire,
            out_dir=os.path.join(
                result_dir, f"iter-{cfg.iteration * n_round}_eval-train"),
            device=self.device)
        # rank 0 wrote the snapshot and the zip that every rank reads next
        pdist.barrier(pdist.default_group())
        return out_zip

    def run(self, initial_label_source: Optional[str] = None,
            resume_round: int = 1,
            first_result_dir: Optional[str] = None,
            label_zip: Optional[str] = None):
        """Full self-training: returns (final_result_dir, final_label_zip).

        initial_label_source: labels for round 1 (the label-generation
        output); later rounds read the previous relabel zip.

        Crash resume (reference --resume_round/--first_result_dir/
        --out_zip_fn, run_train_rounds.py:40-45,245-276): with
        ``resume_round`` = N > 1, rounds 1..N-1 are skipped;
        ``first_result_dir`` is round N-1's completed result dir (its
        latest snapshot seeds round N's trainer state) and ``label_zip``
        its relabel zip (default: the standard iter-<i>_eval-train.0.zip
        inside that dir).  Only files on disk are read, so a fresh
        process can resume a crashed run.
        """
        cfg = self.cfg
        # the rounds' own provenance (each round's trainer writes its
        # args.txt; this records the relabel wire and store choices too)
        if pdist.rank() == 0:
            os.makedirs(cfg.result_base_dir, exist_ok=True)
            with open(os.path.join(cfg.result_base_dir,
                                   "rounds_args.txt"), "w") as f:
                f.write(to_json(cfg))
        if resume_round <= 1:
            prev_dir = self._train_round(1, initial_label_source)
            label_zip = self._relabel(1, prev_dir)
            start = 2
        else:
            if first_result_dir is None:
                raise ValueError("resume_round > 1 needs "
                                 "first_result_dir (the completed round "
                                 f"{resume_round - 1} result dir)")
            prev_dir = first_result_dir
            if label_zip is None:
                label_zip = self._round_zip(resume_round - 1, prev_dir)
            if not os.path.exists(label_zip):
                raise FileNotFoundError(
                    f"resume label zip not found: {label_zip}")
            self.round_dirs.append(prev_dir)
            start = resume_round
        for n_round in range(start, cfg.n_round + 1):
            state = load_snapshot(find_snapshot(prev_dir))
            prev_dir = self._train_round(n_round, label_zip,
                                         resume_state=state)
            label_zip = self._relabel(n_round, prev_dir)
        return prev_dir, label_zip


class _Subset:
    """First-n view of a relabel dataset (reference test_mode's
    n_labels cap, run_train_rounds.py:56-61)."""

    def __init__(self, dataset, n: int):
        self._ds = dataset
        self._n = min(n, len(dataset))

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._ds[i]

    def image_name(self, i):
        return self._ds.image_name(i)

    def __getattr__(self, name):
        # forward optional capabilities (e.g. full_images)
        return getattr(self._ds, name)
