"""Entry points of the port (counterparts of the repository's
``__graft_entry__.py``, which drives the JAX package).

entry()                 the DRN-C-26 forward to its stage-8 feature map
                        (the label path's backbone) and example inputs.
dryrun_multichip(n)     one data-parallel SegNetBasic train step on tiny
                        shapes over n ranks (``torch.distributed``: gloo
                        CPU ranks, or NCCL with a card a rank), checked
                        against the same step on one rank; prints ``ok``.

Run: ``python -c "from spalign_tpu_torch.entry import dryrun_multichip;
dryrun_multichip(2, device='cpu')"``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from spalign_tpu_torch.utils.device import resolve_device

DRYRUN_HW = (32, 64)
DRYRUN_TIMEOUT_S = 600


def entry(device="cuda"):
    """(forward, (model, images)): ``forward(model, images)`` maps (B,
    224, 224, 3) RGB in [0, 255] to the stage-8 map (B, 512, 28, 28) of a
    seed-0 DRN-C-26 on ``device``; the example is 2 images from a seed-0
    numpy stream, as the JAX package's entry."""
    from spalign_tpu_torch.models.drn import (DRN_FACTORIES,
                                              preprocess_imagenet)

    dev = resolve_device(device)
    model = DRN_FACTORIES["drn_c_26"](device=dev)

    def forward(model, images):
        with torch.no_grad():
            _, maps = model(preprocess_imagenet(images))
        return maps[7].permute(0, 3, 1, 2)

    images = torch.as_tensor(
        np.random.RandomState(0).randint(0, 255, (2, 224, 224, 3)),
        dtype=torch.float32, device=dev)
    return forward, (model, images)


def _config(n: int):
    from spalign_tpu_torch.config import TrainConfig

    # MomentumSGD: Adam's first step divides by |gradient|, which turns
    # the ranks' float-order differences on near-zero gradients into
    # lr-sized ones
    return TrainConfig(model="basic", optimizer="MomentumSGD", lr=0.1,
                       weight_decay=5e-4, loss="ce", batchsize=2 * n,
                       input_shape=DRYRUN_HW, eval_shape=DRYRUN_HW,
                       num_devices=n)


def _batch(n: int):
    rng = np.random.RandomState(0)
    images = rng.randn(2 * n, *DRYRUN_HW, 3).astype(np.float32)
    labels = rng.randint(-1, 2, (2 * n, *DRYRUN_HW)).astype(np.int32)
    return images, labels


def _step(cfg, device, images, labels):
    """One train step from the seeded initial weights: (loss, grad_norm,
    state on the CPU)."""
    from spalign_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    m = trainer.train_step(*trainer.to_device(images, labels))
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: v.detach().cpu() for k, v in
             trainer.model.state_dict().items()})


def _rank_main(rank: int, n: int, device_type: str, tmp: str):
    """One rank of the dry run: its rows of the global batch, one step;
    rank 0 saves the result."""
    import torch.distributed as dist

    from spalign_tpu_torch.parallel.dist import rank_slice

    torch.set_num_threads(1)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.backends.cudnn.deterministic = True
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=n)
    try:
        cfg = dataclasses.replace(_config(n),
                                  result_dir=os.path.join(tmp, "ranks"))
        images, labels = _batch(n)
        out = _step(cfg, device, rank_slice(images, rank, n),
                    rank_slice(labels, rank, n))
        if rank == 0:
            torch.save(out, os.path.join(tmp, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One data-parallel SegNetBasic step (MomentumSGD, ce, B = 2n at
    32x64)
    over ``n_devices`` ranks spawned here, against the same global batch
    on one rank in this process: loss and gradient norm within rtol
    1e-5, parameters and BN statistics within rtol 1e-4 / atol 1e-5 (the
    bar of the data-parallel tests).  On the CPU the ranks are gloo
    processes; with ``device="cuda"`` each rank takes a card of its own
    under NCCL, and fewer cards than ranks raise.  Prints ``ok`` and
    returns the numbers."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on CUDA needs {n_devices} "
            f"cards, this machine has {torch.cuda.device_count()}; pass "
            f"device='cpu' for gloo CPU ranks")
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(n_devices, dev.type, tmp),
                                 nprocs=n_devices, join=False,
                                 start_method="spawn")
        deadline = time.time() + DRYRUN_TIMEOUT_S
        while not ctx.join(timeout=1):  # raises if a rank failed
            if time.time() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise RuntimeError(f"the {n_devices} ranks did not finish "
                                   f"within {DRYRUN_TIMEOUT_S} s")
        loss, grad_norm, state = torch.load(os.path.join(tmp, "rank0.pt"),
                                            weights_only=False)
        cfg = dataclasses.replace(_config(n_devices), num_devices=None,
                                  result_dir=os.path.join(tmp, "one"))
        # the ranks' cuDNN algorithms are the deterministic ones too
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            one_loss, one_grad_norm, one_state = _step(
                cfg,
                torch.device(dev.type, 0) if dev.type == "cuda" else dev,
                *_batch(n_devices))
        finally:
            torch.backends.cudnn.deterministic = deterministic
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    np.testing.assert_allclose(loss, one_loss, rtol=1e-5)
    np.testing.assert_allclose(grad_norm, one_grad_norm, rtol=1e-5)
    for k, v in one_state.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[k].float().numpy(),
                                       v.float().numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    out = {"ranks": n_devices, "device": dev.type, "loss": loss,
           "loss_one_rank": one_loss, "grad_norm": grad_norm,
           "grad_norm_one_rank": one_grad_norm,
           "state_bit_equal": all(torch.equal(state[k], v)
                                  for k, v in one_state.items()),
           "seconds": time.time() - t0}
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.6f} "
          f"(one rank {one_loss:.6f}), {dev.type} ranks")
    return out
