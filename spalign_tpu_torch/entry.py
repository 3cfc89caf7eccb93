"""Entry points of the port (counterparts of the repository's
``__graft_entry__.py``, which drives the JAX package).

entry()                 the DRN-C-26 forward to its stage-8 feature map
                        (the label path's backbone) and example inputs.
dryrun_multichip(n)     the JAX dry run's five parts over n ranks
                        (``torch.distributed``: gloo CPU ranks, or NCCL
                        with a card a rank): a data-parallel SegNetBasic
                        train step, the spalign cluster path, the fused
                        SLIC path, the direct and overlaps label
                        generators, and two self-training rounds with
                        sharded relabel; each held to the same call on
                        one rank (the rounds to JAX's own checks); prints
                        ``ok`` for each.

Run: ``python -c "from spalign_tpu_torch.entry import dryrun_multichip;
dryrun_multichip(2, device='cpu')"``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import tempfile
import time

import numpy as np
import torch

from spalign_tpu_torch.utils.device import resolve_device

DRYRUN_HW = (32, 64)
DRYRUN_TIMEOUT_S = 600
# the cluster parts' inputs (__graft_entry__.py:119-156): 8x8x16 feature
# maps and 32x32 maps of 16 segments; SLIC of 32x32 images at 9 segments
CLUSTER_HW, FEATURE_HW, CLUSTER_SEGMENTS = (32, 32), (8, 8), 16
PRIOR = (0.75, 0.5, 0.1, 0.1)
LABEL_FULL_HW = (64, 128)  # the label generators' synthetic frames


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


def _cluster_inputs(n: int):
    """(feature maps (n, 8, 8, 16) float32, maps (n, 32, 32) int32,
    images (n, 32, 32, 3) uint8) of the cluster parts, from seed 1."""
    rng = np.random.RandomState(1)
    fmaps = rng.randn(n, *FEATURE_HW, 16).astype(np.float32)
    sps = rng.randint(0, CLUSTER_SEGMENTS, (n, *CLUSTER_HW)).astype(np.int32)
    imgs = rng.randint(0, 255, (n, *CLUSTER_HW, 3)).astype(np.uint8)
    return fmaps, sps, imgs


def _label_configs(n: int, out_dir: str):
    """The direct and overlaps generators' configurations
    (__graft_entry__.py:168-187), their masks saved under ``out_dir``."""
    from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig

    return {
        "direct": LabelGenConfig(mode="direct", batchsize=n,
                                 resize_shape=(56, 56),
                                 out_dir=os.path.join(out_dir, "direct")),
        "overlaps": LabelGenConfig(
            mode="overlaps", batchsize=n, resize_shape=(56, 56),
            superpixel=SuperpixelConfig(
                method="slic", n_slic_segments=24, slic_iters=2,
                max_superpixels=64, slic_enforce_connectivity=False),
            out_dir=os.path.join(out_dir, "overlaps"))}


def _label_parts(n: int, device, group, out_dir: str) -> dict:
    """The dry run's label paths under ``group`` (None: one rank), each
    part's (result, seconds): the spalign cluster path and the fused SLIC
    path (the whole batch's road masks), the direct and overlaps
    generators (their records; masks under ``out_dir``)."""
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
    from spalign_tpu_torch.kernels.slic import slic, slic_grid_size
    from spalign_tpu_torch.parallel import dist as pdist
    from spalign_tpu_torch.pipeline.direct import make_label_generator
    from spalign_tpu_torch.pipeline.label_gen import (cluster_groups,
                                                      draw_unit)

    fmaps, sps, imgs = _cluster_inputs(n)

    def local(a):
        return torch.as_tensor(pdist.local_rows(a, group), device=device)

    def cluster(features, maps, seed, segments):
        # every rank draws the whole batch's draws and takes its rows
        draws = draw_unit([seed], n, maps.shape[1] * maps.shape[2],
                          segments, device)
        road = cluster_groups(
            features, maps, draws, n_groups=1, n_anchors=4,
            num_segments=segments, append_pos=True, k=3, n_iter=50,
            prior_params=PRIOR, group=group)[0]
        return pdist.all_gather(road, group).cpu().numpy()

    out = {}
    t0 = time.time()
    out["cluster"] = (cluster(local(fmaps), local(sps), 7,
                              CLUSTER_SEGMENTS), time.time() - t0)
    # the fused path: SLIC inside the program, stand-in features (4x4
    # block means of the image)
    t0 = time.time()
    x = local(imgs)
    segments = slic_grid_size(*CLUSTER_HW, 9)
    maps = slic(x, n_segments=9, n_iter=2, device=device)
    features = x.to(torch.float32).reshape(
        -1, FEATURE_HW[0], 4, FEATURE_HW[1], 4, 3).mean(dim=(2, 4))
    out["fused_slic"] = (cluster(features, maps, 8, segments),
                         time.time() - t0)
    ds = SyntheticRoadScenes(n=n, full_shape=LABEL_FULL_HW, seed=5)
    for mode, cfg in _label_configs(n, out_dir).items():
        t0 = time.time()
        records = make_label_generator(cfg, seed=3, device=device,
                                       group=group).process_dataset(ds)
        out[mode] = (records, time.time() - t0)
    return out


class _RelabelView:
    """The rounds' relabel set: (standardized image, gt in {-1, 0, 1})."""

    def __init__(self, n: int):
        from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

        self.ds = SyntheticRoadScenes(n=n, full_shape=DRYRUN_HW, seed=13)

    def __len__(self):
        return len(self.ds)

    def image_name(self, i):
        return self.ds.image_name(i)

    def __getitem__(self, i):
        from spalign_tpu_torch.data.cityscapes import (CITYSCAPES_MEAN,
                                                       CITYSCAPES_STD)

        img, lab = self.ds[i]
        img = (img.astype(np.float32) - CITYSCAPES_MEAN) / CITYSCAPES_STD
        return img, (lab == 7).astype(np.int32)


def _round_sources(n: int, tmp: str):
    """The rounds' 2n scenes as PNG files and their road masks as the
    initial label zip (written once, before the ranks start)."""
    from spalign_tpu_torch.data.png import write_png
    from spalign_tpu_torch.selftrain import NpzShardWriter

    view = _RelabelView(2 * n)
    img_dir = os.path.join(tmp, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    w = NpzShardWriter(os.path.join(tmp, "initial_labels.0.zip"))
    for i in range(len(view)):
        img, lab = view.ds[i]
        base = os.path.splitext(view.image_name(i))[0]
        write_png(os.path.join(img_dir, base + ".png"), img)
        w.put(base, lab == 7)
    w.close()


def _rounds(n: int, device, tmp: str) -> dict:
    """Two self-training rounds on the ranks (__graft_entry__.py:189-257:
    RoundsDriver at 32x64, batch n, Adam, ce, relabel sharded over the
    group); on rank 0 JAX's checks: the final zip exists, every logged
    loss is finite and the loss moved."""
    from spalign_tpu_torch.config import RoundsConfig, TrainConfig
    from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
    from spalign_tpu_torch.parallel import dist as pdist
    from spalign_tpu_torch.selftrain import RoundsDriver

    t0 = time.time()
    img_dir = os.path.join(tmp, "imgs")
    init_zip = os.path.join(tmp, "initial_labels.0.zip")
    rcfg = RoundsConfig(n_round=2, iteration=2, val_iteration=2,
                        batchsize=n, loss="ce",
                        result_base_dir=os.path.join(tmp, "rounds"),
                        eval_shape=DRYRUN_HW)
    tcfg = TrainConfig(model="basic", optimizer="Adam",
                       input_shape=DRYRUN_HW, eval_shape=DRYRUN_HW,
                       num_devices=n)
    driver = RoundsDriver(
        rcfg, tcfg,
        lambda src, soft: EstimatedCityscapesDataset(
            img_dir, src or init_zip, DRYRUN_HW, use_soft_label=soft),
        lambda: _RelabelView(2 * n), device=device)
    _, final_zip = driver.run()
    if pdist.rank():
        return {}
    losses = []
    for rdir in driver.round_dirs:
        with open(os.path.join(rdir, "log.jsonl")) as f:
            losses += [json.loads(line)["main/loss"] for line in f
                       if "main/loss" in line]
    if not os.path.exists(final_zip):
        raise AssertionError(f"no final zip {final_zip}")
    if not (losses and all(np.isfinite(v) for v in losses)):
        raise AssertionError(f"non-finite losses {losses}")
    if losses[-1] == losses[0]:
        raise AssertionError("loss never moved across rounds")
    return {"rounds": len(driver.round_dirs), "losses": losses,
            "final_zip": os.path.basename(final_zip),
            "seconds": time.time() - t0}


def _rank_main(rank: int, n: int, device_type: str, tmp: str):
    """One rank of the dry run: the train step on its rows of the global
    batch, the label parts and the rounds over the group; rank 0 saves
    the results and every rank's kernel launches."""
    import torch.distributed as dist

    from spalign_tpu_torch.kernels import launch_counts
    from spalign_tpu_torch.parallel.dist import gather_objects, rank_slice

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
        t0 = time.time()
        step = _step(cfg, device, rank_slice(images, rank, n),
                     rank_slice(labels, rank, n))
        parts = {"train_step": (step, time.time() - t0)}
        parts.update(_label_parts(n, device, dist.group.WORLD,
                                  os.path.join(tmp, "ranks")))
        parts["rounds"] = _rounds(n, device, tmp)
        launches = gather_objects(launch_counts(), dist.group.WORLD)
        if rank == 0:
            parts["launches"] = {k: sum(c[k] for c in launches)
                                 for k in launches[0]}
            torch.save(parts, os.path.join(tmp, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def _masks_equal(a: str, b: str) -> bool:
    """Every .npy file of directory ``b`` is in ``a`` with equal values."""
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(b, "*.npy")))
    return bool(names) and all(
        os.path.exists(os.path.join(a, fn)) and np.array_equal(
            np.load(os.path.join(a, fn)), np.load(os.path.join(b, fn)))
        for fn in names)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The JAX dry run's five parts over ``n_devices`` ranks spawned here,
    each held to the same call on one rank in this process:

    1. one data-parallel SegNetBasic step (MomentumSGD, ce, B = 2n at
       32x64): loss and gradient norm within rtol 1e-5, parameters and
       BN statistics within rtol 1e-4 / atol 1e-5 (the bar of the
       data-parallel tests);
    2. the spalign cluster path (``cluster_groups``) on random 8x8x16
       feature maps and 32x32 maps of 16 segments: road masks equal;
    3. the fused SLIC path: SLIC of 32x32 images (the Lloyd kernel on
       the card), block-mean features, the cluster path: masks equal;
    4. the direct and overlaps generators at JAX's configurations on n
       synthetic 64x128 scenes (overlaps: the per-sweep SLIC engine,
       the assignment kernel on the card): the saved masks and cluster
       maps equal, TP / FP / FN equal;
    5. two self-training rounds (RoundsDriver, 2 steps a round, Adam,
       relabel sharded over the ranks) on the ranks alone, held to JAX's
       checks: the final zip exists, every logged loss is finite and
       the loss moved.

    On the CPU the ranks are gloo processes; with ``device="cuda"`` each
    rank takes a card of its own under NCCL, and fewer cards than ranks
    raise.  Every rank's kernel launches come back under
    ``"rank_launches"``.  Prints ``ok`` for each part and returns each
    part's result and seconds (``seconds_one_rank``: the call in this
    process)."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on CUDA needs {n_devices} "
            f"cards, this machine has {torch.cuda.device_count()}; pass "
            f"device='cpu' for gloo CPU ranks")
    one_dev = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    t_start = time.time()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        _round_sources(n_devices, tmp)
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
        ranks = torch.load(os.path.join(tmp, "rank0.pt"),
                           weights_only=False)
        cfg = dataclasses.replace(_config(n_devices), num_devices=None,
                                  result_dir=os.path.join(tmp, "one"))
        # the ranks' cuDNN algorithms are the deterministic ones too
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            t0 = time.time()
            one_step = _step(cfg, one_dev, *_batch(n_devices))
            one = {"train_step": (one_step, time.time() - t0)}
            one.update(_label_parts(n_devices, one_dev, None,
                                    os.path.join(tmp, "one")))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        out = {"ranks": n_devices, "device": dev.type,
               "train_step": _check_step(ranks, one)}
        for part in ("cluster", "fused_slic"):
            got, want = ranks[part][0], one[part][0]
            if not np.array_equal(got, want):
                raise AssertionError(f"{part}: the ranks' road masks differ "
                                     f"from one rank's")
            out[part] = {"masks_equal": True, "shape": list(got.shape),
                         "road_px": int(got.sum())}
        for mode in ("direct", "overlaps"):
            got, want = ranks[mode][0], one[mode][0]
            fields = ("img_fn", "TP", "FP", "FN")
            if [[r[k] for k in fields] for r in got] != \
                    [[r[k] for k in fields] for r in want]:
                raise AssertionError(f"{mode}: the ranks' records differ "
                                     f"from one rank's")
            if not _masks_equal(os.path.join(tmp, "ranks", mode),
                                os.path.join(tmp, "one", mode)):
                raise AssertionError(f"{mode}: the ranks' masks differ "
                                     f"from one rank's")
            out[mode] = {"images": len(got), "masks_equal": True,
                         "road_iou": float(np.mean([r["road_iou"]
                                                    for r in got]))}
        for part in ("cluster", "fused_slic", "direct", "overlaps"):
            out[part].update(seconds=ranks[part][1],
                             seconds_one_rank=one[part][1])
    out["rounds"] = ranks["rounds"]
    out["rank_launches"] = ranks["launches"]
    out["seconds"] = time.time() - t_start
    step, rounds = out["train_step"], out["rounds"]
    print(f"dryrun_multichip({n_devices}): ok, {n_devices} {dev.type} "
          f"ranks, {out['seconds']:.1f} s\n"
          f"  train_step: ok, loss={step['loss']:.6f} (one rank "
          f"{step['loss_one_rank']:.6f})\n"
          f"  cluster: ok, road masks equal to one rank\n"
          f"  fused_slic: ok, road masks equal to one rank\n"
          f"  direct: ok, masks equal to one rank, road IoU "
          f"{out['direct']['road_iou']:.3f}\n"
          f"  overlaps: ok, masks equal to one rank, road IoU "
          f"{out['overlaps']['road_iou']:.3f}\n"
          f"  rounds: ok, {rounds['rounds']} rounds, loss "
          f"{rounds['losses'][0]:.4f} -> {rounds['losses'][-1]:.4f}, "
          f"{rounds['final_zip']}", flush=True)
    return out


def _check_step(ranks: dict, one: dict) -> dict:
    """The train step's result against one rank's, at the data-parallel
    tests' bar."""
    (loss, grad_norm, state), seconds = ranks["train_step"]
    (one_loss, one_grad_norm, one_state), one_seconds = one["train_step"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    np.testing.assert_allclose(loss, one_loss, rtol=1e-5)
    np.testing.assert_allclose(grad_norm, one_grad_norm, rtol=1e-5)
    for k, v in one_state.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[k].float().numpy(),
                                       v.float().numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    return {"loss": loss, "loss_one_rank": one_loss,
            "grad_norm": grad_norm, "grad_norm_one_rank": one_grad_norm,
            "state_bit_equal": all(torch.equal(state[k], v)
                                   for k, v in one_state.items()),
            "seconds": seconds, "seconds_one_rank": one_seconds}
