"""Data-parallel SegNet trainer (counterpart of ``spalign_tpu/train/trainer.py``).

The train step is eager PyTorch: forward in train mode (batch statistics,
running averages updated), the loss, backward, the optimizer.  The loss
and gradient norm stay on the device; the host reads them only at
``log_interval``.

Data parallelism: one process per device under ``torchrun
--nproc_per_node N`` (``parallel/dist.py``).  Each rank takes its rows of
every global batch; batch norm sees the global batch, the ``ce`` loss
divides by the global valid count, and one all-reduce a step averages
the flattened gradients (and the loss) before the optimizer, so an
N-rank step is the one-device step of the JAX package.  At world size 1
nothing is reduced.  Rank 0 alone writes ``args.txt``, the logs, the
training curves and the snapshots.

Optimizers match the reference recipes (train_segnet.py:230-240, 260-263):
Adam (the README recipe; chainer's and optax's defaults, lr 1e-3) or
MomentumSGD(lr, momentum=0.9) with coupled weight decay and x0.1 every
``decay_iteration`` updates (optax's staircase: update k, counted from 0,
runs at lr * 0.1 ** (k // decay_iteration)).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict
from typing import Iterable

import torch

from spalign_tpu_torch.config import TrainConfig
from spalign_tpu_torch.models.segnet import build_segnet
from spalign_tpu_torch.parallel import dist as pdist
from spalign_tpu_torch.train.losses import rank_loss_fn
from spalign_tpu_torch.utils.curves import write_curves
from spalign_tpu_torch.utils.device import full_float32
from spalign_tpu_torch.utils.timers import device_span, span, tracing

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def build_model(cfg: TrainConfig, device="cuda") -> torch.nn.Module:
    """cfg.model's SegNet with random weights from cfg.seed.
    compute_dtype='bfloat16' runs convs and BN in bfloat16 with float32
    parameters (flax mixed precision)."""
    return build_segnet(cfg.model, cfg.n_class, _DTYPES[cfg.compute_dtype],
                        device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))


def lr_at(cfg: TrainConfig, update: int) -> float:
    """Learning rate of update ``update`` (counted from 0)."""
    if cfg.optimizer == "Adam":
        return 1e-3
    if cfg.decay_iteration > 0:
        return cfg.lr * 0.1 ** (update // cfg.decay_iteration)
    return cfg.lr


def make_optimizer(cfg: TrainConfig, params):
    """(optimizer, lr scheduler or None) of the reference recipes."""
    params = list(params)
    if cfg.optimizer == "Adam":
        return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999),
                                eps=1e-8), None
    if cfg.optimizer == "MomentumSGD":
        # chainer WeightDecay hook: grad += wd * param (coupled L2)
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9,
                              weight_decay=cfg.weight_decay)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda k: lr_at(cfg, k) / cfg.lr)
        return opt, sched
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


class Trainer:
    """Training loop with the reference's observability surface: JSONL
    log (LogReport), stdout rows (PrintReport), snapshots every
    val_interval, evaluation, args.txt provenance
    (train_segnet.py:253-303).

    Args:
      cfg: TrainConfig.  ``num_devices``: the ranks of the process group
        (None: the group's world size, 1 without a group).
      model: a SegNet module (default: ``build_model(cfg, device)``).
      device: 'cuda' (default; raises without CUDA; under ``torchrun``
        ``cuda:LOCAL_RANK``) or 'cpu'.
    """

    def __init__(self, cfg: TrainConfig, model=None, device="cuda"):
        with span("setup.trainer"):
            self.device = pdist.setup(device)
            self.world, self.rank = pdist.world_size(), pdist.rank()
            if cfg.num_devices not in (None, self.world):
                raise ValueError(
                    f"num_devices={cfg.num_devices} but the process group "
                    f"has {self.world} rank(s): launch one process per "
                    f"device with torchrun --nproc_per_node "
                    f"{cfg.num_devices}")
            pdist.shard_size(cfg.batchsize, self.world)
            self.cfg = cfg
            full_float32(self.device)
            self.model = (build_model(cfg, self.device) if model is None
                          else model.to(self.device))
            self.model.train()
            if self.world > 1:
                # every rank starts from rank 0's weights and statistics
                for t in self.model.state_dict().values():
                    torch.distributed.broadcast(t, 0)
            self.optimizer, self.scheduler = make_optimizer(
                cfg, self.model.parameters())
            self.loss_fn = rank_loss_fn(cfg.loss, self.world)
            self.step = 0
            self._log_path = os.path.join(cfg.result_dir, "log")
            self._log: list = []
            self._t0 = time.time()
            if self.rank == 0:
                os.makedirs(cfg.result_dir, exist_ok=True)
                with open(os.path.join(cfg.result_dir, "args.txt"),
                          "w") as f:
                    json.dump(asdict(cfg), f, indent=4, sort_keys=True,
                              default=str)

    def to_device(self, images, labels):
        """Host batch (numpy or tensors) -> device tensors."""
        with span("train.h2d", step=self.step):
            return (torch.as_tensor(images, dtype=torch.float32,
                                    device=self.device),
                    torch.as_tensor(labels, device=self.device))

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> dict:
        """One update on this rank's rows of a global batch (the whole
        batch at world size 1); returns device scalars {'loss',
        'grad_norm'} of the global batch without reading them."""
        with span("train.step", step=self.step):
            self.model.train()
            loss = self.loss_fn(self.model(images), labels)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            if self.world > 1:
                loss = self._average(grads, loss.detach())
            grad_norm = torch.sqrt(sum((g.float() * g.float()).sum()
                                       for g in grads))
            self.optimizer.step()
            if self.scheduler is not None:
                self.scheduler.step()
            self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    def _average(self, grads, loss):
        """Average the gradients (in place) and the loss over the ranks
        in one all-reduce; returns the averaged loss.  Its span takes
        the device time too while a profiler records."""
        name = "train.grad_allreduce"
        with (device_span(name, self.device) if tracing() else span(name)):
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.reshape(1)])
            torch.distributed.all_reduce(flat)
            flat /= self.world
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        return flat[-1]

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": (None if self.scheduler is None
                              else self.scheduler.state_dict())}

    def load_state_dict(self, state: dict):
        """Resume from a snapshot (``checkpoints.load_snapshot``)."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and state.get("scheduler"):
            self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])

    def fit(self, train_iter: Iterable, evaluator=None,
            checkpointer=None):
        """Train until cfg.train_iters.  ``train_iter`` yields (images
        (B, H, W, 3) float32, labels) host arrays: this rank's rows of
        each global batch (``PrefetchLoader(rank=, world=)``), the whole
        batch at world size 1.  ``evaluator(model)`` returns a metrics
        dict (every rank calls it); after it, rank 0 draws the training
        curves (``utils/curves.py``: loss.png, ious.png, prerec.png,
        accuracy.png) into cfg.result_dir.  ``checkpointer(step,
        state_dict)`` runs on rank 0."""
        cfg = self.cfg
        fit_t0, fit_step0 = time.time(), self.step
        for images, labels in train_iter:
            if self.step >= cfg.train_iters:
                break
            metrics = self.train_step(*self.to_device(images, labels))
            step = self.step
            if step % cfg.log_interval == 0 or step == cfg.train_iters:
                # ProgressBar analog (train_segnet.py:290): rate since
                # fit start + ETA
                loss = float(metrics["loss"])
                rate = (step - fit_step0) / max(time.time() - fit_t0, 1e-9)
                self._report({
                    "iteration": step, "main/loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": lr_at(cfg, step),
                    "elapsed_time": time.time() - self._t0,
                    "iters_per_sec": rate,
                    "eta_seconds": max(cfg.train_iters - step, 0)
                    / max(rate, 1e-9),
                    "progress": step / max(cfg.train_iters, 1)})
            if step % cfg.val_interval == 0 or step == cfg.train_iters:
                if evaluator is not None:
                    ev = evaluator(self.model)
                    self._report({"iteration": step,
                                  **{f"val/{k}": v for k, v in ev.items()}})
                    if self.rank == 0:
                        write_curves(self._log, cfg.result_dir)
                if checkpointer is not None and self.rank == 0:
                    checkpointer(step, self.state_dict())
                self._flush_log()
        self._flush_log()
        return self

    def _report(self, rec: dict):
        """Stream a JSONL line (log.jsonl) and a stdout row; the
        reference-format ``log`` JSON array is rewritten at eval points
        and at the end of fit.  Rank 0 only."""
        if self.rank:
            return
        self._log.append(rec)
        with open(self._log_path + ".jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(" ".join(f"{k}={v:.6g}" if isinstance(v, float) else
                       f"{k}={v}" for k, v in rec.items()))

    def _flush_log(self):
        """Chainer-LogReport-format dump (one JSON array named ``log``)."""
        if self.rank:
            return
        with open(self._log_path, "w") as f:
            json.dump(self._log, f, indent=2)
