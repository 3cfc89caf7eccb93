"""Benchmarks of the port on one NVIDIA GPU: label generation (all three
modes) and SegNet training.

    python -m spalign_tpu_torch.bench [--mode slic|...|all] [--breakdown]

Counterpart of the JAX package's ``bench.py`` at the repository root, with
its modes, configurations (``label_gen_cfg``), repetitions, metric names,
units and ``vs_baseline`` constants.  The default invocation times the
headline workload -- the superpixel-align road-label pipeline (DRN-C-26
features + device SLIC superpixels + align + prior + joint weighted
k-means + mask painting) at the reference configuration (clustering
batch 30, 224x224 inputs, k=4, 10 anchors) -- and prints ONE JSON line
``{"metric", "value", "unit", "vs_baseline", "scored_value", ...}``;
``--mode all`` prints one line per mode, in ``MODES`` order.  Each line
also carries the card's name and power limit (``device``,
``power_limit_w``, from nvidia-smi).  Without CUDA it exits 2 and prints
no line: no number from another device is printed under a metric name.

Fences: a timed pass ends when its records are on the host, and a
record is made only after its unit's bit-packed masks have landed there
(``finish_batch``), scored or not; a train step's time ends with
``torch.cuda.synchronize()`` after the last step's loss.  The first pass
of each mode warms up, untimed; the kernels and the host library are
built before any mode runs (their seconds go to stderr).

``--breakdown`` prints each mode's per-stage host wall-clock means to
stderr, and a device-program probe: CUDA events around 10 ``run_unit``
calls on a wire already on the card (the superpixel maps too where the
mode uploads them), each call with other seeds, against the convolutions'
operations (2 x MACs of every DRN-C-26 convolution at the unit's shape;
SegNetBasic's forward x 3 for a train step) over the H100's dense peak
(989 TFLOP/s bf16, 67 TFLOP/s float32 without TF32), beside the card's
power limit.

Checks (a failed one raises, so the run exits non-zero and prints no
line for that mode): the record count of every repetition, a finite
``road_iou`` on every scored record, and every unit's masks landed as
bit-packed uint8 of its road masks' shape.

Baselines (bench.py's module docstring): the reference's ~1.2 img/s per
2017-class GPU for spalign, 0.25 img/s for overlaps (full-resolution
felzenszwalb on a CPU core), 3 img/s for direct and relabel, 350
ms/step for training on 8 such GPUs.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from spalign_tpu_torch import native
from spalign_tpu_torch.config import (LabelGenConfig, SuperpixelConfig,
                                      TrainConfig)

REFERENCE_IMAGES_PER_SEC = 1.2
REFERENCE_OVERLAPS_IMAGES_PER_SEC = 0.25
REFERENCE_DIRECT_IMAGES_PER_SEC = 3.0
REFERENCE_RELABEL_IMAGES_PER_SEC = 3.0
REFERENCE_TRAIN_MS_PER_STEP = 350.0

BATCH = 30
GROUPS = 5  # clustering batches run together in one unit in slic mode
N_BATCHES_TIMED = 5
FULL_SHAPE = (1024, 2048)
SCENE_SEED = 7
MODES = ("slic", "slic_scored", "slic_d2", "slic_cc", "felzenszwalb",
         "direct", "overlaps", "overlaps_slic", "relabel", "train",
         "train_bf16")
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 without
# the tensor cores (TF32 off)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PROBE_CALLS = 10


def label_gen_cfg(mode: str) -> LabelGenConfig:
    """bench.py's ``_label_gen_cfg``: the configuration of a label mode."""
    if mode in ("slic", "slic_scored"):
        sp = SuperpixelConfig(method="slic", n_slic_segments=100,
                              slic_iters=10, max_superpixels=256,
                              slic_enforce_connectivity=False)
        return LabelGenConfig(batchsize=BATCH, superpixel=sp,
                              groups_per_dispatch=GROUPS,
                              upload_format="yuv420", save_masks=False)
    if mode == "slic_d2":
        base = label_gen_cfg("slic")
        return dataclasses.replace(base, superpixel=dataclasses.replace(
            base.superpixel, slic_device_downscale=2))
    if mode == "slic_cc":
        sp = SuperpixelConfig(method="slic", n_slic_segments=100,
                              slic_iters=10, max_superpixels=256,
                              slic_enforce_connectivity=True)
        return LabelGenConfig(batchsize=BATCH, superpixel=sp,
                              save_masks=False)
    if mode == "direct":
        return LabelGenConfig(mode="direct", batchsize=BATCH,
                              upload_format="yuv420", save_masks=False)
    if mode == "felzenszwalb":
        sp = SuperpixelConfig(method="felzenszwalb",
                              felzenszwalb_scale=300.0,
                              felzenszwalb_sigma=0.8,
                              felzenszwalb_min_size=20,
                              max_superpixels=2048)
        return LabelGenConfig(batchsize=BATCH, superpixel=sp,
                              save_masks=False)
    if mode == "overlaps":
        sp = SuperpixelConfig(method="felzenszwalb",
                              felzenszwalb_scale=500.0,
                              felzenszwalb_sigma=0.9,
                              felzenszwalb_min_size=20,
                              max_superpixels=65536)
        return LabelGenConfig(mode="overlaps", batchsize=BATCH,
                              superpixel=sp, save_masks=False)
    if mode == "overlaps_slic":
        sp = SuperpixelConfig(method="slic", n_slic_segments=1024,
                              slic_iters=5, max_superpixels=2048,
                              slic_enforce_connectivity=False,
                              slic_device_downscale=2)
        return LabelGenConfig(mode="overlaps", batchsize=8,
                              superpixel=sp, upload_format="yuv420",
                              save_masks=False)
    raise ValueError(mode)


def train_cfg(compute_dtype: str = "float32", **sizes) -> TrainConfig:
    """bench.py's ``bench_train`` recipe (train_segnet.py:41-94):
    SegNetBasic, global batch 8, 512x1024, Adam, ``ce``."""
    recipe = dict(model="basic", batchsize=8, optimizer="Adam", loss="ce",
                  input_shape=(512, 1024), compute_dtype=compute_dtype)
    return TrainConfig(**{**recipe, **sizes})


# bench.py's ``bench_relabel`` recipe: 32 images at 512x1024, batch 8,
# soft labels stored in float16 at 1024x2048 (the eval store) or at the
# network resolution (the rounds' default store)
RELABEL = dict(n_images=32, batch=8, input_shape=(512, 1024),
               eval_shape=(1024, 2048), score_dtype=np.float16)
RELABEL_STORES = {"eval": {}, "network": {"score_store": "network"}}


def metric_name(mode: str) -> str:
    if mode == "slic":
        return "label_gen_images_per_sec"
    if mode == "relabel":
        return "relabel_images_per_sec"
    if mode == "train":
        return "segnet_train_ms_per_step"
    if mode == "train_bf16":
        return "segnet_train_bfloat16_ms_per_step"
    return f"label_gen_{mode}_images_per_sec"


def baseline(mode: str) -> float:
    """The reference figure ``vs_baseline`` divides by (or, for ms/step
    rows, is divided by)."""
    return {"overlaps": REFERENCE_OVERLAPS_IMAGES_PER_SEC,
            "overlaps_slic": REFERENCE_OVERLAPS_IMAGES_PER_SEC,
            "direct": REFERENCE_DIRECT_IMAGES_PER_SEC,
            "relabel": REFERENCE_RELABEL_IMAGES_PER_SEC,
            "train": REFERENCE_TRAIN_MS_PER_STEP,
            "train_bf16": REFERENCE_TRAIN_MS_PER_STEP}.get(
        mode, REFERENCE_IMAGES_PER_SEC)


def sync(device):
    """Wait for the card's queued work (a host clock starts and stops only
    after it); nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class BenchCheckError(RuntimeError):
    """A bench check failed: the mode prints no line."""


def check(cond, msg: str):
    if not cond:
        raise BenchCheckError(f"bench check failed: {msg}")


@functools.lru_cache(maxsize=2)
def scenes(n: int, full_shape=FULL_SHAPE, seed: int = SCENE_SEED):
    """``SyntheticRoadScenes(n, full_shape, seed)`` rendered on 8 threads:
    (frames (n, H, W, 3) uint8, labelIds (n, H, W) uint8), cached for the
    modes of one run: callers read them and never write them."""
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

    ds = SyntheticRoadScenes(n=n, full_shape=full_shape, seed=seed)
    with ThreadPoolExecutor(8) as pool:
        items = list(pool.map(ds.__getitem__, range(n)))
    return (np.stack([im for im, _ in items]),
            np.stack([lab for _, lab in items]))


class InMemory:
    """bench.py's ``_InMemory``: ``n_batches`` batches of ``batch``
    indices cycling over pre-resized frames (decode is the storage
    format's cost, not the pipeline's); ``labels`` (full-resolution
    labelIds) turn on scoring, ``fulls`` feed the overlaps mode."""

    def __init__(self, frames, fulls=None, n_batches=N_BATCHES_TIMED,
                 batch=BATCH, labels=None):
        self.frames = frames
        self.fulls = fulls
        self.labels = labels
        self.n_src = len(frames)
        self.n_batches = n_batches
        self.batch = batch

    def __len__(self):
        return self.n_batches * self.batch

    def image_name(self, i):
        return f"bench_{i:06d}.png"

    def label_name(self, i):
        return f"bench_{i:06d}_labelIds.png"

    def resized_batch(self, indices, hw):
        idx = [i % self.n_src for i in indices]
        labs = self.labels[idx] if self.labels is not None else None
        return self.frames[idx], labs

    def full_images(self, indices):
        return self.fulls[[i % self.n_src for i in indices]]


def _timed_counts(mode):
    """bench.py's (batches, repetitions) of a label mode."""
    if mode == "overlaps":
        return 2, 1
    if mode in ("slic", "slic_scored", "slic_d2"):
        return 3 * GROUPS, 5
    if mode == "overlaps_slic":
        return 4, 3
    return N_BATCHES_TIMED, 5


def bench_label_gen(mode: str, breakdown: bool = False,
                    reps: int | None = None, *, device="cuda",
                    n_batches: int | None = None, batch: int | None = None,
                    full_shape=FULL_SHAPE, resize_shape=None) -> dict:
    """Images per second of a label mode: the best of ``reps`` timed
    passes of ``n_batches`` batches after one warm-up pass.  The keyword
    sizes override bench.py's (the tests run the CPU at a tiny size)."""
    from spalign_tpu_torch.pipeline.direct import make_label_generator

    scored = mode == "slic_scored"
    cfg = label_gen_cfg(mode)
    if batch is not None:
        cfg = dataclasses.replace(cfg, batchsize=batch)
    if resize_shape is not None:
        cfg = dataclasses.replace(cfg, resize_shape=tuple(resize_shape))
    bs = cfg.batchsize
    default_batches, default_reps = _timed_counts(mode)
    n_batches = default_batches if n_batches is None else n_batches
    reps = default_reps if reps is None else reps
    fulls, label_ids = scenes(2 * bs, tuple(full_shape))
    gen = make_label_generator(cfg, device=device)
    mem = InMemory(native.resize_cubic_u8(fulls, cfg.resize_shape),
                   fulls if gen.needs_full_images else None,
                   n_batches=n_batches, batch=bs,
                   labels=label_ids if scored else None)

    # every unit's masks land on the host bit-packed, scored or not: the
    # unit's road masks (at 1/u when the mode packs them so) in bytes of 8
    orig_finish = gen.finish_batch

    def finish_and_land(prepared, handles, timers):
        road, cluster, diag = orig_finish(prepared, handles, timers)
        packed = handles["host"]["road_packed"]
        u = int(handles.get("packed_upscale", 1))
        n, mh, mw = road.shape
        want = (n, mh // u, -(-(mw // u) // 8))
        check(isinstance(packed, np.ndarray) and packed.dtype == np.uint8
              and packed.shape == want,
              f"{mode}: masks landed as {type(packed).__name__} "
              f"{getattr(packed, 'dtype', None)} "
              f"{getattr(packed, 'shape', None)}, want uint8 {want}")
        return road, cluster, diag

    gen.finish_batch = finish_and_land

    gen.process_dataset(mem, save=False)  # warm-up, untimed
    best_dt, best_records = float("inf"), None
    for _ in range(reps):
        sync(gen.device)
        t0 = time.time()
        records = gen.process_dataset(mem, save=False)
        sync(gen.device)
        dt = time.time() - t0
        check(len(records) == n_batches * bs,
              f"{mode}: {len(records)} records, want {n_batches * bs}")
        if dt < best_dt:
            best_dt, best_records = dt, records
    imgs_per_sec = bs * n_batches / best_dt
    if scored:
        check(all(np.isfinite(r.get("road_iou", np.nan))
                  for r in best_records), f"{mode}: a road_iou not finite")
    if breakdown:
        print_breakdown(mode, gen, best_records, imgs_per_sec)
    return {"metric": metric_name(mode),
            "value": round(float(imgs_per_sec), 3),
            "unit": "img/s",
            "vs_baseline": round(float(imgs_per_sec / baseline(mode)), 2)}


def conv_flops(model: torch.nn.Module, run) -> tuple:
    """2 x the multiply-adds of every ``nn.Conv2d`` that ``run()`` calls
    in ``model``, from each call's weight and output shapes: (flops,
    convolution calls)."""
    seen = []

    def hook(mod, _inputs, out):
        n, _, ho, wo = out.shape
        cout, cin_g, kh, kw = mod.weight.shape
        seen.append(2 * n * ho * wo * cout * cin_g * kh * kw)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return float(sum(seen)), len(seen)


def _require_card(device: torch.device, what: str):
    if device.type != "cuda":
        raise RuntimeError(f"{what} times the card; device is {device}")


def print_breakdown(mode, gen, records, imgs_per_sec):
    """Stage means of the best pass, then the device-program probe, to
    stderr."""
    from spalign_tpu_torch.kernels import launch_counts
    from spalign_tpu_torch.pipeline.label_gen import fused_superpixels
    from spalign_tpu_torch.pipeline.superpixels import compute_superpixels

    stages = {}
    for r in records:
        for k, v in r.items():
            if k.startswith("time_"):
                stages.setdefault(k, []).append(v)
    print(f"--- {mode}: {imgs_per_sec:.1f} img/s; per-batch stage means "
          f"(s; host wall-clock, stages overlap across pipeline slots):",
          file=sys.stderr)
    for k, v in sorted(stages.items()):
        print(f"    {k:<18} {np.mean(v):8.4f}", file=sys.stderr)

    cfg, dev = gen.cfg, gen.device
    _require_card(dev, "the device-program probe")
    groups = max(1, cfg.groups_per_dispatch)
    n_imgs = cfg.batchsize * groups  # the unit shape the bench ran
    imgs = np.random.RandomState(0).randint(
        0, 255, (n_imgs, *cfg.resize_shape, 3), np.uint8)
    wire = torch.from_numpy(native.pack_yuv420(imgs)
                            if cfg.upload_format == "yuv420"
                            else imgs).to(dev)
    sps = None
    if cfg.mode == "spalign" and not fused_superpixels(cfg):
        sps = torch.from_numpy(compute_superpixels(
            imgs, cfg.superpixel, device=dev)[0]).to(dev)

    def call(base_seed):
        seeds = [np.uint32(base_seed + g) for g in range(groups)]
        if sps is not None:
            return gen.run_unit(wire, seeds, sps=sps)
        return gen.run_unit(wire, seeds)

    call(7000)  # warm
    torch.cuda.synchronize(dev)
    before = launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in range(PROBE_CALLS):
        call(1000 + 10 * s)
    end.record()
    end.synchronize()
    dev_t = start.elapsed_time(end) / 1e3 / PROBE_CALLS
    launches = {k: (v - before[k]) / PROBE_CALLS
                for k, v in launch_counts().items() if v != before[k]}
    flops, n_convs = conv_flops(gen.net, lambda: gen.features(
        gen.decode(wire)))
    peak = PEAK_FLOPS["bfloat16" if cfg.model_dtype == "bfloat16"
                      else "float32"]
    name, power_w = card()
    print(f"    device program    {dev_t:8.4f} s/unit ({n_imgs / dev_t:.0f} "
          f"img/s device-bound; CUDA events around {PROBE_CALLS} run_unit "
          f"calls of {groups}x{cfg.batchsize} images on a wire already on "
          f"the card; kernel launches a unit {launches})", file=sys.stderr)
    print(f"    convolutions      {flops / 1e9:.1f} GFLOP/unit (2 x MACs of "
          f"the {n_convs} DRN-C-26 convolutions at {n_imgs}x"
          f"{cfg.resize_shape[0]}x{cfg.resize_shape[1]}) -> "
          f"{flops / dev_t / peak * 100:.2f}% of the {peak / 1e12:.0f} "
          f"TFLOP/s {cfg.model_dtype} dense peak ({name}, "
          f"{power_w:.2f} W limit)", file=sys.stderr)


class _RelabelImages:
    """bench.py's relabel dataset: standardized-from-uint8 images (the
    uint8 wire), varied per index, with gt labels in {-1, 0, 1}."""

    def __init__(self, n, hw, eval_hw):
        from spalign_tpu_torch.data.cityscapes import (CITYSCAPES_MEAN,
                                                       CITYSCAPES_STD)

        self.n, self.hw, self.eval_hw = n, tuple(hw), tuple(eval_hw)
        self.mean, self.std = CITYSCAPES_MEAN, CITYSCAPES_STD

    def __len__(self):
        return self.n

    def image_name(self, i):
        return f"bench_{i:06d}.png"

    def __getitem__(self, i):
        r = np.random.RandomState(100 + i)
        u8 = r.randint(0, 256, (*self.hw, 3)).astype(np.float32)
        img = ((u8 - self.mean) / self.std).astype(np.float32)
        return img, r.randint(-1, 2, self.eval_hw).astype(np.int32)


def bench_relabel(breakdown: bool = False, reps: int = 3, *,
                  device="cuda", **sizes) -> dict:
    """Self-training relabel pass (labels_from_segnet.py:26-153 +
    run_train_rounds.py:191-235): SegNetBasic (random weights, seed 0)
    predicts soft float16 pseudo-labels into a zip, the ``eval`` and
    ``network`` score stores interleaved, best of ``reps`` each.  ``value``
    is the eval store (the reference's disk format), and
    ``network_store_value`` the rounds' default store.  ``sizes``
    override ``RELABEL`` (the tests)."""
    from spalign_tpu_torch.models.segnet import build_segnet
    from spalign_tpu_torch.selftrain.relabel import relabel_dataset

    rc = dict(RELABEL, **sizes)
    n_imgs, batch = rc["n_images"], rc["batch"]
    model = build_segnet("basic", 2, device=device,
                         generator=torch.Generator().manual_seed(0))
    ds = _RelabelImages(n_imgs, rc["input_shape"], rc["eval_shape"])
    best = {name: float("inf") for name in RELABEL_STORES}
    with tempfile.TemporaryDirectory() as td:
        for rep in range(reps):
            for name, kw in RELABEL_STORES.items():
                out = os.path.join(td, f"r{rep}.{name}.zip")
                sync(device)
                t0 = time.time()
                recs = relabel_dataset(model, None, ds, out,
                                       eval_shape=rc["eval_shape"],
                                       batch_size=batch, soft_label=True,
                                       score_dtype=rc["score_dtype"],
                                       device=device, **kw)
                sync(device)
                dt = time.time() - t0
                check(len(recs) == n_imgs,
                      f"relabel {name}: {len(recs)} records, want {n_imgs}")
                best[name] = min(best[name], dt)
    rate = {name: n_imgs / b for name, b in best.items()}
    if breakdown:
        print(f"--- relabel: {rate['network']:.2f} img/s soft-f16 "
              f"network-res store (production default) / "
              f"{rate['eval']:.2f} eval-res store (reference format); "
              f"batch {batch}, {n_imgs} imgs, interleaved best-of-{reps}",
              file=sys.stderr)
    return {"metric": metric_name("relabel"),
            "value": round(float(rate["eval"]), 3), "unit": "img/s",
            "vs_baseline": round(float(rate["eval"] / baseline("relabel")),
                                 2),
            "network_store_value": round(float(rate["network"]), 3)}


def bench_train(breakdown: bool = False, compute_dtype: str = "float32",
                reps: int = 3, *, device="cuda", steps: int = 10,
                **sizes) -> dict:
    """SegNetBasic train step at the reference recipe (``train_cfg``), on
    one card and no process group (bench.py picks the most devices that
    divide the batch: one here): the best of ``reps`` runs of ``steps``
    steps on fresh inputs, uploaded before the clock starts.  ``sizes``
    override TrainConfig fields (the tests)."""
    from spalign_tpu_torch.train.trainer import Trainer

    mode = "train" if compute_dtype == "float32" else "train_bf16"
    with tempfile.TemporaryDirectory() as td:
        cfg = train_cfg(compute_dtype, result_dir=td, **sizes)
        trainer = Trainer(cfg, device=device)
        dev = trainer.device
        rng = np.random.RandomState(0)
        h, w = cfg.input_shape

        def batch():
            imgs = rng.rand(cfg.batchsize, h, w, 3).astype(np.float32)
            labels = rng.randint(-1, 2, (cfg.batchsize, h, w)).astype(
                np.int32)
            return trainer.to_device(imgs, labels)

        loss = float(trainer.train_step(*batch())["loss"])  # warm-up
        best = float("inf")
        for _ in range(reps):
            bs = [batch() for _ in range(steps)]  # fresh inputs
            sync(dev)
            t0 = time.time()
            for imgs, labels in bs:
                metrics = trainer.train_step(imgs, labels)
            loss = float(metrics["loss"])
            sync(dev)
            best = min(best, (time.time() - t0) / steps)
        check(np.isfinite(loss), f"{mode}: loss {loss}")
        ms = best * 1000.0
        if breakdown:
            _train_breakdown(trainer, cfg, ms, imgs)
    return {"metric": metric_name(mode),
            "value": round(ms, 2), "unit": "ms/step",
            "vs_baseline": round(baseline(mode) / ms, 2)}


def _train_breakdown(trainer, cfg, ms, imgs):
    _require_card(trainer.device, "the train step's FLOP rate")
    h, w = cfg.input_shape
    mode = "train" if cfg.compute_dtype == "float32" else "train_bf16"
    print(f"--- {mode}: {ms:.1f} ms/step on 1 device, global batch "
          f"{cfg.batchsize} @ {h}x{w}; 2000-iter recipe ~ "
          f"{2000 * ms / 1e3 / 60:.1f} min",
          file=sys.stderr)
    model = trainer.model
    model.eval()
    try:
        fwd, n_convs = conv_flops(model, lambda: model(imgs))
    finally:
        model.train()
    peak = PEAK_FLOPS[cfg.compute_dtype]
    name, power_w = card()
    print(f"    step = {3 * fwd / 1e9:.1f} GFLOP (3 x the forward's 2 x MACs "
          f"of {n_convs} SegNetBasic convolutions) -> "
          f"{3 * fwd / (ms / 1e3) / peak * 100:.2f}% of the "
          f"{peak / 1e12:.0f} TFLOP/s {cfg.compute_dtype} dense peak "
          f"({name}, {power_w:.2f} W limit)", file=sys.stderr)


def run_mode(mode: str, breakdown: bool = False, reps: int | None = None,
             device="cuda") -> dict:
    """One mode's row at bench.py's sizes (``reps``: its repetitions, or
    bench.py's when None)."""
    if mode in ("train", "train_bf16"):
        return bench_train(breakdown, "float32" if mode == "train"
                           else "bfloat16", 3 if reps is None else reps,
                           device=device)
    if mode == "relabel":
        return bench_relabel(breakdown, 3 if reps is None else reps,
                             device=device)
    return bench_label_gen(mode, breakdown, reps, device=device)


@functools.lru_cache(maxsize=1)
def card() -> tuple:
    """(name, power limit in W) of CUDA device 0, as nvidia-smi reads
    them; the name must be ``torch.cuda.get_device_name(0)``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    if name != torch.cuda.get_device_name(0):
        raise RuntimeError(f"nvidia-smi names {name!r}, torch "
                           f"{torch.cuda.get_device_name(0)!r}")
    return name, float(limit.split()[0])


def build_kernels() -> dict:
    """Build the CUDA kernels and the host library, one compiler each,
    started together: {source: seconds} (0 when already built)."""
    from spalign_tpu_torch.kernels import pooling, slic_assign, slic_fused

    libs = [slic_fused.LIBRARY, slic_assign.LIBRARY, pooling.LIBRARY,
            native.LIBRARY]
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = [pool.submit(lib.get) for lib in libs]
    for f in futures:
        f.result()
    return {lib.source.name: lib.build_seconds for lib in libs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Benchmarks of the port on one NVIDIA GPU (bench.py's "
                    "modes); one JSON line per mode on stdout.")
    p.add_argument("--mode", default="slic", choices=[*MODES, "all"])
    p.add_argument("--breakdown", action="store_true",
                   help="print per-stage means + the device-program probe "
                        "to stderr")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    name, power_w = card()
    t0 = time.time()
    built = build_kernels()
    print(f"builds: {json.dumps(built)} ({time.time() - t0:.1f} s, "
          f"together)", file=sys.stderr)
    modes = MODES if args.mode == "all" else (args.mode,)
    for m in modes:
        row = run_mode(m, args.breakdown)
        if m == "slic" and args.mode == "slic":
            # the GT-scored rate rides the default line (bench.py:645-657):
            # 2 repetitions, a regression canary for the scoring path
            scored = bench_label_gen("slic_scored", args.breakdown, reps=2)
            row["scored_value"] = scored["value"]
            row["scored_unit"] = scored["unit"]
            row["scored_vs_baseline"] = scored["vs_baseline"]
        row["device"] = name
        row["power_limit_w"] = power_w
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
