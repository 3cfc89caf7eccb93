"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it: the label
path (stage 1), then SegNetBasic self-training on its labels (stage 2):
training, relabeling and rounds; then the remaining tools of the README
workflow and the ablation sweeps.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA GPU and
``nvcc``.  Phases, one JSON line each on stdout:

  device       the card (nvidia-smi name and power limit), CUDA, PyTorch
  build        nvcc builds of csrc/slic_lloyd.cu, csrc/slic_assign.cu and
               csrc/pooling.cu and the g++ build of the host library
               csrc/host_ops.cpp (felzenszwalb, connectivity, the scorer,
               the yuv420 pack, PNG un-filtering, the cubic resize), run
               together; ptxas's resource use per kernel
  slic_lloyd   the SLIC Lloyd kernel against its plain PyTorch version on
               the inputs the main path gives it (150 x 224^2, 100
               segments, 10 sweeps): labels bit-equal; its cluster size;
               times by CUDA events
  main_path    SpalignLabelGenerator at the bench configuration (DRN-C-26
               full width in bf16, 5 groups x 30 images per unit, yuv420
               wire, k=4, 10 anchors) over synthetic scenes with ground
               truth: a warm-up unit, then 3 timed units; every count set
               to 0 just before and read just after; the kernel must have
               launched, no road mask may be empty, no feature NaN
  slic_assign  the SLIC assignment kernel (csrc/slic_assign.cu) against its
               plain version at the overlaps path's inputs (30 frames at
               1024x2048, K = 98) with the grid centres and with the centres
               after 3 sweeps, at K = 990 on 2 frames, on a ragged H*W and
               with every window empty: labels bit-equal and the fused
               int64 centre sums equal to bincount's; the labelled and the
               sums-only launch timed beside their plain versions, their
               bounds and the sums' yardsticks (bincount, index_add_); the
               whole per-sweep SLIC split into its fused launches, centre
               updates and final launch; at 30 x 512x1024 the per-sweep
               engine against the Lloyd kernel (labels equal) and both times
  features     bf16 against float32 DRN features (reported, not gated)
  pooling      the pool, scatter and gather kernels against their plain
               versions at the train step's four level shapes (B = 8,
               C = 64, 512x1024 down to 64x128) in float32 and bfloat16,
               and one SegNet shape at C = 512: values, codes and
               gradients must be bit-equal; float32 times by CUDA events
               beside the bound, the plain versions and PyTorch's own
               max_pool2d / max_unpool2d (yardsticks the port never calls)
  train_path   stage 1 feeds stage 2: 60 synthetic frames at 512x1024
               labelled by SpalignLabelGenerator into .npy masks, read back
               by EstimatedCityscapesDataset through a PrefetchLoader;
               Trainer at the reference recipe (SegNetBasic, 2 classes,
               B = 8, 512x1024, Adam, ce, float32 without TF32): 2 warm-up
               steps, then 20 timed steps with every count set to 0 just
               before and read just after (4 pools, 8 scatters, 4 gathers
               a step), one step split by CUDA events, one step under
               torch.profiler (device busy time, top kernels), then the
               Evaluator on 8 synthetic scenes at 1024x2048; losses
               finite and falling, metrics finite
  overlaps_path  make_label_generator in the overlaps mode (DRN-C-26 full
               width, bf16, 224^2 features, batch 30, yuv420 wire, device
               SLIC of the 1024x2048 frames: 100 segments, 10 sweeps) with
               ground truth: a warm-up batch, then 3 timed batches with every
               count set to 0 just before and read just after (11 assignment
               launches a batch, 10 of them sums-only); masks full
               resolution and not empty; the full-frame yuv420 pack, C++
               and numpy, timed and equal; one batch with
               slic_device_downscale=2 (2x2-block-constant masks)
  direct_path  the direct mode at the bench unit (5 groups x 30 at 224^2,
               yuv420): a warm-up unit, then 3 timed units
  cli          spalign_tpu_torch.cli.label_gen.main in the overlaps mode on
               4 synthetic scenes at 1024x2048, in-process
  host_library felzenszwalb (300 / 0.8 / 20) of golden_frames() must give
               the sha256 the JAX package's library gives
               (GOLDEN_MAPS_SHA256); the native scorer must equal the plain
               one on the 60 labelIds at 512x1024; ms per image of both,
               and of felzenszwalb at 224^2 and at 1024x2048
  host_superpixels_path  SpalignLabelGenerator with the default
               SuperpixelConfig() (felzenszwalb, max_superpixels 1024) at
               the bench unit on the rgb8 wire: a warm-up unit, 3 timed
               units; no road mask empty, counts within the bound, the
               peak device memory below the unchunked align's 23.1 GB; then
               one unit with SLIC + the connectivity pass, which must launch
               the Lloyd kernel, and one default unit at max_superpixels
               4096, which must complete; superpixel_align at the unit's
               shapes chunked and in one chunk: equal, device ms and peak
  parity_path  one batch of 30 in the bit-parity mode (felzenszwalb,
               float32 DRN); its parity stages re-run on the CPU from the
               card's features and maps must give the same cluster maps
  overlaps_felzenszwalb_path  the overlaps mode with felzenszwalb of the
               30 frames at 1024x2048, max_superpixels the largest count
               they give: a warm-up and a timed batch; then one batch with
               SLIC + the connectivity pass (11 assignment launches)
  real_files   60 synthetic 1024x2048 scenes written by the port's PNG
               encoder as a Cityscapes tree and zips; decode must give the
               frames back, the cubic resize its plain version and the
               golden hash (GOLDEN_RESIZE_SHA256), the C++ yuv420 pack the
               numpy pack (a unit of 150 at 224^2 and 30 full frames, both
               timed); then cli.label_gen on --cityscapes_dir (the default
               felzenszwalb), on the zip pair with SLIC + connectivity (the
               Lloyd kernel must launch) and on an image file list without
               labels (its PNG masks must equal the .npy masks); then
               cli.train on the image zip and the directory run's masks at
               the reference recipe for 12 steps, evaluated on 8 frames at
               1024x2048 (the pooling kernels must launch)
  selftrain    two self-training rounds (RoundsDriver) on real_files' tree
               at the reference recipe: SegNetBasic, Adam, B = 8, 512x1024,
               eval 1024x2048, float32 without TF32, 10 steps a round, the
               label CLI's masks as round 1's labels, the soft loss from
               round 2 on round 1's float16 network-resolution scores;
               then ``python -m spalign_tpu_torch.cli.relabel`` on round 2's
               snapshot in the reference's disk format (eval store,
               float32).  Seconds and ms per step of each round, relabel
               images/s and host seconds per batch by stage, zip bytes,
               road IoU, peak memory, pooling launches (exact counts);
               channel 1 of every stored score must be 1 - ch0 bit for
               bit, round 2's reader must pair round 1's zip, and the
               CLI's first 2 frames must equal a CPU re-run on >= 0.999 of
               the PRED pixels with a mean score delta <= 1e-3
  data_parallel  3 train steps of the reference recipe under a one-rank
               NCCL group (env://, a free port) against the same steps
               without a group: losses, parameters and BN statistics
               bit-equal (deterministic cuDNN algorithms)
  workflow     the README's remaining tools on what real_files and
               selftrain wrote, in-process: cli.convert_model --check on a
               seed-0 DRN's .pth (card against CPU), cli.make_zips of the
               val images, cli.bottom_half on the val zips (equal to a
               numpy recompute), cli.mean_result on the label CLI's
               result.json (equal to aggregate_results), cli.make_table
               --plot on the rounds (a row a round, a PDF); then
               cli.demo_video from the train CLI's snapshot over 30 frames
               (SegNetBasic, input 512x1024, pred 1024x2048, batch 8):
               frames/s, host seconds a batch by stage, AVI bytes, the
               frame count of its avih header, pool and scatter launches
               counted exactly, the JPEG encoder's ms a 2 MP frame (equal
               to its numpy reference) and the first 2 masks against a CPU
               re-run (>= 0.999 of the pixels)
  sweep        cli.sweep in-process on main_path's frames, one unit of 150
               a value: fig 7 (k = 2..8) on the device-SLIC unit (the
               Lloyd kernel must launch) and fig 9's felzenszwalb scale at
               100, 300, 800 on the default unit, images/s and road IoU a
               value; then one dynamic-k generator against fresh static
               generators on the same seed stream at k = 2 and 8: equal
               cluster maps

then the ``kernels`` line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
then exits non-zero without the last line.  Without CUDA it exits 2.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
N_SCENES = 30
N_FULL_SCENES = 15  # at 1024x2048, with their mirror images: 30 frames
FULL_HW = (1024, 2048)
UNIT = 150  # 5 groups x 30 images
OVERLAPS_BATCHES = 3
# the SegNetBasic train step's pooling levels (B, H, W, C) at 512x1024
POOL_LEVELS = [(8, 512 >> i, 1024 >> i, 64) for i in range(4)]
SEGNET_SHAPE = (8, 64, 128, 512)  # SegNet's fourth block at 512x1024
TRAIN_WARMUP, TRAIN_TIMED = 2, 20
# the default felzenszwalb unit's peak device memory with the align
# unchunked (PERF.md: chip_smoke, PR 5, run 2), and the segment bound of
# the unit that the chunked align must complete
PEAK_BEFORE_CHUNKING = 23_111_624_704
S_LARGE = 4096
# real_files: the fake Cityscapes tree, the frames of its val zips and of
# its no-label file list, and the train CLI's steps
REAL_SCENES, VAL_FRAMES, LIST_FRAMES, REAL_TRAIN_STEPS = 60, 8, 30, 12
# selftrain: rounds, steps a round, frames re-run on the CPU; data_parallel
SELFTRAIN_ROUNDS, ROUND_STEPS, CPU_FRAMES, DP_STEPS = 2, 10, 2, 3
# workflow: demo_video's frames and batch (the reference's batch 8)
DEMO_FRAMES, DEMO_BATCH = 30, 8
TRAIN_HW = (512, 1024)  # the reference recipe's input shape
CITIES = ("aachen", "bochum", "bremen")
POOL_SOURCE = "spalign_tpu_torch/csrc/pooling.cu"
POOL_REPLACES = {"pool2x2": "spalign_tpu/kernels/pooling_pallas.py:83",
                 "scatter2x2": "spalign_tpu/kernels/pooling_pallas.py:119",
                 "gather2x2": "spalign_tpu/kernels/pooling_pallas.py:149"}
# felzenszwalb at the reference parameters (scale 300, sigma 0.8, min size
# 20) on golden_frames(): the sha256 of the frames and of the int32 maps,
# as the JAX package's own library gives them (tests/test_torch_native.py
# holds both constants to it)
FELZENSZWALB_PARAMS = (300.0, 0.8, 20)
GOLDEN_FRAMES_SHA256 = (
    "1dad725882efc7f10d2ac17610918e0b70923d856b5c6a2ab4c3c0bd70405c85")
GOLDEN_MAPS_SHA256 = (
    "122c977460887e78740a4ad6cdff34157559dee94c065db5af9b66fab94688f2")
# golden_frames() resized to 224x224 by the host library's cubic resize
# (tests/test_torch_png.py holds it to the port and its plain version)
GOLDEN_RESIZE_SHA256 = (
    "bec7bd2981752ef19798c2d37cf5d7c1bfe3ff8d7260f4a9f562eb9d61181c61")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Frames:
    """In-memory dataset: ``n`` indices cycling over pre-resized frames
    and their full-resolution labelIds; ``full`` (optional) holds the
    frames at full resolution for ``frames[i]`` readers."""

    def __init__(self, frames, labels, n, full=None):
        self.frames, self.labels, self.n, self.full = frames, labels, n, full

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        j = i % len(self.labels)
        return self.full[j], self.labels[j]

    def image_name(self, i):
        return f"smoke_{i:06d}.png"

    def label_name(self, i):
        return f"smoke_{i:06d}_labelIds.png"

    def resized_batch(self, indices, hw):
        idx = [i % len(self.frames) for i in indices]
        return self.frames[idx], self.labels[idx]

    def full_images(self, indices):
        return self.full[[i % len(self.full) for i in indices]]


def scenes512():
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

    return SyntheticRoadScenes(n=N_SCENES, full_shape=(512, 1024), seed=7)


def make_scenes():
    """30 synthetic scenes at 512x1024 and their mirror images: 60 frames
    with their labelIds, both at 512x1024."""
    imgs, labels = scenes512().resized_batch(range(N_SCENES), (512, 1024))
    frames = np.concatenate([imgs, imgs[:, :, ::-1]])
    labels = np.concatenate([labels, labels[:, :, ::-1]])
    return np.ascontiguousarray(frames), np.ascontiguousarray(labels)


def golden_frames():
    """The first 4 frames of ``make_scenes()`` strided to 256x512: uint8
    frames made without a resize."""
    imgs, _ = scenes512().resized_batch(range(4), (512, 1024))
    return np.ascontiguousarray(imgs[:, ::2, ::2])


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def felzenszwalb_maps(felzenszwalb, frames):
    """(B, H, W) int32 maps of ``felzenszwalb`` (the port's or the JAX
    package's binding) at FELZENSZWALB_PARAMS, as the label paths call
    it (frames / 255 in float32)."""
    return np.stack([felzenszwalb(f.astype(np.float32) / 255.0,
                                  *FELZENSZWALB_PARAMS)
                     for f in frames]).astype(np.int32)


def make_full_scenes():
    """15 synthetic scenes at 1024x2048 and their mirror images: 30 frames
    with their labelIds (made on 8 threads)."""
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

    ds = SyntheticRoadScenes(n=N_FULL_SCENES, full_shape=FULL_HW, seed=13)
    with ThreadPoolExecutor(8) as pool:
        items = list(pool.map(ds.__getitem__, range(N_FULL_SCENES)))
    imgs = np.stack([im for im, _ in items])
    labels = np.stack([lab for _, lab in items])
    frames = np.concatenate([imgs, imgs[:, :, ::-1]])
    labels = np.concatenate([labels, labels[:, :, ::-1]])
    return np.ascontiguousarray(frames), np.ascontiguousarray(labels)


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def lloyd_bound_ms(lab, c0, shape, n_iter):
    """Least time of the Lloyd loop on an H100: the larger of its bytes
    (lab and c0 read once, labels written once) over HBM bandwidth and
    its float32 operations over the non-tensor float32 peak.  Operations
    counted from this run's inputs: per sweep, the score (5 multiplies,
    4 adds, 1 subtract) of every (pixel, centre) pair within the window
    of the initial centres, and 6 adds a pixel for the centre sums."""
    import torch

    b, _, hw = lab.shape
    n_bytes = lab.numel() * 4 + c0.numel() * 4 + b * hw * 4
    w = shape["width"]
    pix = torch.arange(hw, device=lab.device)
    py = torch.div(pix, w, rounding_mode="floor").float()
    px = (pix % w).float()
    cy, cx = c0[0, :, 3], c0[0, :, 4]  # the grid is the same per image
    in_win = (((py[:, None] - cy[None]).abs() <= shape["window"])
              & ((px[:, None] - cx[None]).abs() <= shape["window"]))
    pairs = int(in_win.sum()) * b
    n_ops = (n_iter + 1) * pairs * 10 + n_iter * b * hw * 6
    return (*bound_ms(n_bytes, n_ops), n_bytes, n_ops)


def window_pairs(centers, shape):
    """(pixel, centre) pairs within the window, summed over the batch:
    the window test is separable, so each centre's pairs are its rows in
    the window times its columns in the window (the kernel's float32
    compares)."""
    import torch

    win = torch.tensor(shape["window"], dtype=torch.float32,
                       device=centers.device)
    ys = torch.arange(shape["height"], dtype=torch.float32,
                      device=centers.device)
    xs = torch.arange(shape["width"], dtype=torch.float32,
                      device=centers.device)
    ny = ((ys - centers[..., 3:4]).abs() <= win).sum(-1)
    nx = ((xs - centers[..., 4:5]).abs() <= win).sum(-1)
    return int((ny * nx).sum())


def assign_bound_ms(lab, centers, shape):
    """Least time of one assignment launch on an H100: the larger of its
    bytes (lab and the centres read once, labels written once) over HBM
    bandwidth and its float32 operations over the non-tensor float32
    peak, counted from this run's centres: the score (5 multiplies, 4
    adds, 1 subtract) of every (pixel, centre) pair within the window."""
    b, _, hw = lab.shape
    n_bytes = lab.numel() * 4 + centers.numel() * 4 + b * hw * 4
    n_ops = window_pairs(centers, shape) * 10
    return (*bound_ms(n_bytes, n_ops), n_bytes, n_ops)


def bound_ms(n_bytes, n_ops):
    """(least milliseconds on an H100, "bytes" or "operations"): the
    larger of the bytes over HBM bandwidth and the float32 operations
    over the non-tensor float32 peak."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def build_libraries(libs):
    """Build every CUDA library at once: one nvcc per source, started
    together.  Raises the first failure after every build has ended."""
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = [pool.submit(lib.get) for lib in libs]
    for f in futures:
        f.result()


def ptxas_lines(lib):
    return [ln.strip() for ln in lib.build_log.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln]


def exact_err(a, b) -> float:
    """max |a - b| over elements that differ (equal infinities count 0)."""
    import torch

    a, b = a.float(), b.float()
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def pool_input(shape, dtype, seed):
    """Normal values with a band zeroed, so that ties are common (as
    after relu, and as in tests/test_pooling_pallas.py)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda")
    x[x.abs() < 0.4] = 0.0
    return x.to(dtype)


def pool_bytes(shape, dtype):
    """Bytes each kernel must move at this big-side shape: every input
    read once, every output written once (codes are int8)."""
    import torch

    big = int(np.prod(shape))
    small = big // 4
    es = torch.finfo(dtype).bits // 8
    return {"pool2x2": big * es + small * es + small,
            "scatter2x2": small * es + small + big * es,
            "gather2x2": big * es + small + small * es}


def pooling_phase():
    """Each kernel against its plain version at the train step's shapes;
    float32 times at the four levels.  Returns the per-kernel summary
    (sums over the four float32 levels: one pass of each family)."""
    import torch
    import torch.nn.functional as F

    from spalign_tpu_torch.kernels import pooling as pk

    cases = [(s, torch.float32) for s in POOL_LEVELS]
    cases += [(s, torch.bfloat16) for s in POOL_LEVELS]
    cases += [(SEGNET_SHAPE, torch.float32), (SEGNET_SHAPE, torch.bfloat16)]
    summary = {k: {"max_abs_err": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "library_ms": 0.0, "bound_by": "bytes"}
               for k in POOL_REPLACES}
    rows = []
    for i, (shape, dtype) in enumerate(cases):
        x = pool_input(shape, dtype, 3 * i)
        pooled, codes = pk.pool2x2(x)
        y = pool_input(pooled.shape, dtype, 3 * i + 1)
        g = pool_input(shape, dtype, 3 * i + 2)
        up, down = pk.scatter2x2(y, codes), pk.gather2x2(g, codes)
        torch.cuda.synchronize()
        p_ref, c_ref = pk.pool2x2_reference(x)
        errs = {"pool2x2": max(exact_err(pooled, p_ref),
                               exact_err(codes, c_ref)),
                "scatter2x2": exact_err(up, pk.scatter2x2_reference(
                    y, codes)),
                "gather2x2": exact_err(down, pk.gather2x2_reference(
                    g, codes))}
        del p_ref, c_ref
        row = {"shape": list(shape), "dtype": str(dtype)[6:],
               "max_abs_err": errs}
        for k, e in errs.items():
            summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], e)
        if dtype == torch.float32 and shape in POOL_LEVELS:
            n_bytes = pool_bytes(shape, dtype)
            small = pooled.numel()
            # compares and selects per pooled element
            n_ops = {"pool2x2": 3 * small, "scatter2x2": 4 * small,
                     "gather2x2": 3 * small}
            calls = {"pool2x2": (lambda: pk.pool2x2(x),
                                 lambda: pk.pool2x2_reference(x)),
                     "scatter2x2": (lambda: pk.scatter2x2(y, codes),
                                    lambda: pk.scatter2x2_reference(
                                        y, codes)),
                     "gather2x2": (lambda: pk.gather2x2(g, codes),
                                   lambda: pk.gather2x2_reference(
                                       g, codes))}
            # PyTorch's own calls on the same tensors (NCHW views of the
            # NHWC memory): yardsticks only
            xn, yn, gn = (t.permute(0, 3, 1, 2) for t in (x, y, g))
            _, ind = F.max_pool2d(xn, 2, 2, return_indices=True)
            yr = yn.detach().requires_grad_(True)
            unpooled = F.max_unpool2d(yr, ind, 2)
            library = {
                "pool2x2": lambda: F.max_pool2d(xn, 2, 2,
                                                return_indices=True),
                "scatter2x2": lambda: F.max_unpool2d(yn, ind, 2),
                "gather2x2": lambda: torch.autograd.grad(
                    unpooled, yr, gn, retain_graph=True)}
            times = {}
            for k, (kernel, plain) in calls.items():
                kernel_ms, _ = cuda_ms(kernel, reps=20)
                plain_ms, _ = cuda_ms(plain, reps=3, warmup=1)
                library_ms, _ = cuda_ms(library[k], reps=20)
                least_ms, bound_by = bound_ms(n_bytes[k], n_ops[k])
                times[k] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": least_ms,
                            "bound_by": bound_by, "bytes": n_bytes[k],
                            "GB_per_s": n_bytes[k] / kernel_ms / 1e6}
                for key in ("kernel_ms", "plain_ms", "library_ms",
                            "bound_ms"):
                    summary[k][key] += times[k][key]
                if bound_by != "bytes":
                    summary[k]["bound_by"] = bound_by
            row["times"] = times
            del unpooled, yr, ind
        rows.append(row)
        del x, y, g, pooled, codes, up, down
        torch.cuda.empty_cache()
    emit({"phase": "pooling", "cases": rows,
          "per_pass_f32": summary})
    for k, v in summary.items():
        check(v["max_abs_err"] == 0.0, f"{k} bit-equal to its plain version")
    return summary


class TimedIter:
    """Wraps an iterator and sums the host seconds spent waiting in
    ``next``."""

    def __init__(self, it):
        self.it = iter(it)
        self.wait = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self.it)
        self.wait += time.perf_counter() - t0
        return item

    def close(self):
        self.it.close()  # stops the loader's producer thread


def step_breakdown(trainer, batch):
    """One train step split by CUDA events: forward + loss, backward,
    optimizer.  Device milliseconds."""
    import torch

    images, labels = trainer.to_device(*batch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = trainer.loss_fn(trainer.model(images), labels)
    ev[1].record()
    trainer.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    ev[2].record()
    trainer.optimizer.step()
    ev[3].record()
    ev[3].synchronize()
    return {"forward_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "optimizer_ms": ev[2].elapsed_time(ev[3])}


# kernel classes of the profiled step, by kernel name
KERNEL_CLASSES = [
    ("pooling kernels", re.compile(r"pool_kernel|scatter_kernel|"
                                   r"gather_kernel")),
    ("convolution", re.compile(r"xmma|wgrad|dgrad|fft|gemm|conv|cudnn",
                               re.I)),
    ("scan (LRN cumsum)", re.compile(r"scan")),
    ("elementwise and reductions", re.compile(r".")),
]


def profile_step(trainer, batch, top=20):
    """One train step under torch.profiler: the device kernels' total
    time against the step's wall time, the time by kernel class, and
    the ``top`` kernels (None where the profiler recorded no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    images, labels = trainer.to_device(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    if not kernels:
        return {"kernels_ms": None, "wall_ms": wall_ms, "top": None}
    kernels.sort(key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    for e in kernels:
        name = next(n for n, pat in KERNEL_CLASSES if pat.search(e.key))
        by_class[name] += device_us(e) / 1e3
    return {"kernels_ms": busy_ms, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "by_class_ms": by_class,
            "top": [{"name": e.key[:100], "calls": e.count,
                     "device_ms": device_us(e) / 1e3}
                    for e in kernels[:top]]}


def val_batch():
    """8 synthetic scenes at 1024x2048: images resized to 512x1024 and
    standardized, ground truth from create_label_mask at 1024x2048."""
    from spalign_tpu_torch.data.estimated import (CITYSCAPES_MEAN,
                                                  CITYSCAPES_STD)
    from spalign_tpu_torch.data.labels import create_label_mask
    from spalign_tpu_torch.data.synthetic import (SyntheticRoadScenes,
                                                  resize_bicubic_f32)

    ds = SyntheticRoadScenes(n=8, full_shape=(1024, 2048), seed=11)
    imgs, gts = [], []
    for i in range(len(ds)):
        img, lab = ds[i]
        img = resize_bicubic_f32(img.astype(np.float32), (512, 1024))
        imgs.append((img - CITYSCAPES_MEAN) / CITYSCAPES_STD)
        gts.append(create_label_mask(lab))
    return np.stack(imgs).astype(np.float32), np.stack(gts)


def train_phase(label_cfg, frames224, frames512, labels, pool_summary):
    """Stage 1 labels 60 frames into .npy masks; stage 2 trains
    SegNetBasic on them at the reference recipe.  Returns the kernel
    launch counts of the timed steps."""
    import torch

    from spalign_tpu_torch.config import TrainConfig
    from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
    from spalign_tpu_torch.data.loader import PrefetchLoader
    from spalign_tpu_torch.kernels import pooling as pk
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator
    from spalign_tpu_torch.train.evaluator import Evaluator
    from spalign_tpu_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    mask_dir = os.path.join(tmp, "labels")
    frames = Frames(frames224, labels, len(frames512), full=frames512)
    t0 = time.time()
    gen = SpalignLabelGenerator(dataclasses.replace(
        label_cfg, out_dir=mask_dir, save_masks=True))
    records = gen.process_dataset(frames, save=True)
    t_label = time.time() - t0
    check(len(records) == len(frames512), "one pseudo-label per frame")

    dataset = EstimatedCityscapesDataset(frames, mask_dir, (512, 1024))
    check(len(dataset) == len(frames512), "every frame pairs with a mask")
    loader = TimedIter(PrefetchLoader(dataset, 8, shuffle=True,
                                      num_workers=8, seed=0))
    cfg = TrainConfig(model="basic", n_class=2, batchsize=8,
                      input_shape=(512, 1024), eval_shape=(1024, 2048),
                      optimizer="Adam", loss="ce", compute_dtype="float32",
                      train_iters=TRAIN_WARMUP, log_interval=1,
                      val_interval=10 ** 9,
                      result_dir=os.path.join(tmp, "train"))
    trainer = Trainer(cfg)
    t0 = time.time()
    trainer.fit(loader)
    torch.cuda.synchronize()
    t_warm = time.time() - t0

    trainer.cfg = dataclasses.replace(
        cfg, train_iters=TRAIN_WARMUP + TRAIN_TIMED)
    loader.wait = 0.0
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(loader)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = {"pool2x2": pk.pool2x2.launches,
                "scatter2x2": pk.scatter2x2.launches,
                "gather2x2": pk.gather2x2.launches}
    peak = torch.cuda.max_memory_allocated()
    wait = loader.wait

    breakdown = step_breakdown(trainer, next(loader))
    profiled = profile_step(trainer, next(loader))
    loader.close()
    with open(os.path.join(cfg.result_dir, "log")) as f:
        losses = [r["main/loss"] for r in json.load(f) if "main/loss" in r]
    t0 = time.time()
    val = val_batch()
    t_val_data = time.time() - t0
    t0 = time.time()
    metrics = Evaluator(trainer.model, lambda: iter([val]),
                        cfg.eval_shape)()
    t_eval = time.time() - t0

    step_ms = elapsed / TRAIN_TIMED * 1e3
    pool_ms = (pool_summary["pool2x2"]["kernel_ms"]
               + 2 * pool_summary["scatter2x2"]["kernel_ms"]
               + pool_summary["gather2x2"]["kernel_ms"])
    device_ms = sum(breakdown.values())
    emit({"phase": "train_path", "model": "SegNetBasic", "n_class": 2,
          "batch": 8, "input_shape": [512, 1024], "optimizer": "Adam",
          "loss": "ce", "dtype": "float32",
          "tf32": bool(torch.backends.cudnn.allow_tf32
                       or torch.backends.cuda.matmul.allow_tf32),
          "label_frames": len(records), "label_seconds": t_label,
          "label_mean_road_iou": float(np.mean([r["road_iou"]
                                                for r in records])),
          "warmup_steps": TRAIN_WARMUP, "warmup_seconds": t_warm,
          "timed_steps": TRAIN_TIMED, "seconds": elapsed,
          "ms_per_step": step_ms,
          "images_per_s": 8 * TRAIN_TIMED / elapsed,
          "loader_wait_ms_per_step": wait / TRAIN_TIMED * 1e3,
          "one_step_device_ms": breakdown,
          "one_step_device_total_ms": device_ms,
          "pooling_kernels_ms_per_step": pool_ms,
          "pooling_share_of_device_step": pool_ms / device_ms,
          "profiled_step": profiled,
          "first_loss": losses[0], "last_loss": losses[-1],
          "losses": losses, "launches": launches,
          "launches_per_step": {k: v / TRAIN_TIMED
                                for k, v in launches.items()},
          "peak_memory_bytes": peak,
          "val": metrics, "val_images": len(val[0]),
          "val_data_seconds": t_val_data, "eval_seconds": t_eval})
    check(len(losses) == TRAIN_WARMUP + TRAIN_TIMED, "one loss per step")
    check(all(np.isfinite(losses)), "finite losses")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), "the loss falls")
    check(launches == {"pool2x2": 4 * TRAIN_TIMED,
                       "scatter2x2": 8 * TRAIN_TIMED,
                       "gather2x2": 4 * TRAIN_TIMED},
          f"4, 8 and 4 launches per step, got {launches}")
    check(all(np.isfinite(v) for v in metrics.values()),
          "finite val metrics")
    return launches


def per_sweep_split(lab, c0, shape, n_iter):
    """The per-sweep engine's loop (``kernels/slic.py::slic_per_sweep``)
    with CUDA events around its parts: device milliseconds of the
    ``n_iter`` fused launches (centre sums, no labels), the ``n_iter``
    ``centers_from_sums`` updates, the final labelled launch, and the
    whole."""
    import torch

    from spalign_tpu_torch.kernels.slic_assign import (centers_from_sums,
                                                       slic_assign)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    torch.cuda.synchronize()
    start = event()
    centers, marks = c0, []
    for _ in range(n_iter):
        a0 = event()
        sums = slic_assign(lab, centers, sums=True, **shape)
        a1 = event()
        centers = centers_from_sums(sums, centers)
        marks.append((a0, a1, event()))
    a0 = event()
    slic_assign(lab, centers, **shape)
    end = event()
    end.synchronize()
    return {"fused_ms": sum(m[0].elapsed_time(m[1]) for m in marks),
            "centers_from_sums_ms": sum(m[1].elapsed_time(m[2])
                                        for m in marks),
            "final_ms": a0.elapsed_time(end),
            "total_ms": start.elapsed_time(end)}


def assign_check(lab, centers, shape):
    """Kernel against plain version: max |label difference| (0 when
    bit-equal), whether the labels lie in [0, K), and whether the fused
    int64 sums equal bincount's over the plain labels."""
    import torch

    from spalign_tpu_torch.kernels.slic_assign import (center_sums,
                                                       pixel_rows,
                                                       slic_assign,
                                                       slic_assign_reference)

    got = slic_assign(lab, centers, **shape)
    sums = slic_assign(lab, centers, sums=True, **shape)
    torch.cuda.synchronize()
    want = slic_assign_reference(lab, centers, **shape)
    want_sums = center_sums(pixel_rows(lab, shape["width"]), want, centers)
    err = int((got.long() - want.long()).abs().max())
    k = centers.shape[1]
    return (err, bool(((got >= 0) & (got < k)).all()),
            torch.equal(sums, want_sums))


def sums_bound_ms(lab, centers, shape):
    """Least time of one fused-sums launch on an H100: its bytes (lab and
    the centres read once, the (B, K, 6) int64 sums written once) against
    its operations (the score of every in-window pair and 6 adds a
    pixel), as ``assign_bound_ms`` counts them."""
    b, _, hw = lab.shape
    n_bytes = (lab.numel() * 4 + centers.numel() * 4
               + centers.shape[0] * centers.shape[1] * 6 * 8)
    n_ops = window_pairs(centers, shape) * 10 + b * hw * 6
    return (*bound_ms(n_bytes, n_ops), n_bytes, n_ops)


def slic_assign_phase(frames_full, frames512, sp):
    """The assignment kernel at the overlaps path's inputs, K ~ 1000, a
    ragged H*W and empty windows, labels and fused sums; the centre sums'
    yardsticks; the whole per-sweep SLIC and its split;
    the two engines at 30 x 512x1024."""
    import torch

    from spalign_tpu_torch import native
    from spalign_tpu_torch.kernels import slic_assign as sa
    from spalign_tpu_torch.kernels import slic_fused
    from spalign_tpu_torch.kernels.slic import slic_inputs, slic_per_sweep
    from spalign_tpu_torch.pipeline.wire import decode_yuv420

    dev = torch.device("cuda")
    seg, comp, n_iter = sp.n_slic_segments, sp.slic_compactness, sp.slic_iters
    wire = torch.from_numpy(native.pack_yuv420(frames_full)).to(dev)
    images = decode_yuv420(wire, FULL_HW)
    del wire
    lab, c0, shape = slic_inputs(images, seg, comp)
    k = c0.shape[1]

    def sweeps(c, n, kw):
        for _ in range(n):
            c = sa.centers_from_sums(sa.slic_assign(lab, c, sums=True, **kw),
                                     c)
        return c

    c3 = sweeps(c0, 3, shape)
    checks = {"grid": assign_check(lab, c0, shape),
              "after_3_sweeps": assign_check(lab, c3, shape)}
    kernel_ms, kernel_runs = cuda_ms(lambda: sa.slic_assign(lab, c3, **shape),
                                     reps=20)
    sums_ms, sums_runs = cuda_ms(
        lambda: sa.slic_assign(lab, c3, sums=True, **shape), reps=20)
    plain_ms, _ = cuda_ms(
        lambda: sa.slic_assign_reference(lab, c3, **shape), reps=3, warmup=1)
    least_ms, bound_by, n_bytes, n_ops = assign_bound_ms(lab, c3, shape)
    sums_least_ms, sums_by, sums_bytes, sums_ops = sums_bound_ms(lab, c3,
                                                                 shape)
    labels = sa.slic_assign(lab, c3, **shape)
    rows = sa.pixel_rows(lab, shape["width"])
    sums = sa.slic_assign(lab, c3, sums=True, **shape)
    # the same integer sums by bincount over float64 (center_sums, the
    # plain version) and by index_add_ over int64: yardsticks of the
    # fused sums
    plain_sums_ms, _ = cuda_ms(
        lambda: sa.center_sums(rows, sa.slic_assign_reference(lab, c3,
                                                              **shape), c3),
        reps=3, warmup=1)
    slots = len(c3) * k
    rows_i64 = rows.to(torch.int64)
    ids = (labels.long() + (torch.arange(len(c3), device=dev) * k)[:, None]
           ).reshape(-1)

    def index_add():
        return torch.zeros((6, slots), dtype=torch.int64,
                           device=dev).index_add_(1, ids, rows_i64)

    update = {
        "bincount_float64": cuda_ms(lambda: sa.center_sums(rows, labels, c3),
                                    reps=10)[0],
        "index_add_int64": cuda_ms(index_add, reps=10)[0],
        "centers_from_sums": cuda_ms(lambda: sa.centers_from_sums(sums, c3),
                                     reps=20)[0]}
    same_sums = (torch.equal(index_add().T.reshape(len(c3), k, 6), sums)
                 and torch.equal(sa.center_sums(rows, labels, c3), sums))
    del rows, rows_i64, ids, sums
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    split = per_sweep_split(lab, c0, shape, n_iter)
    slic_ms, _ = cuda_ms(lambda: slic_per_sweep(lab, c0, n_iter=n_iter,
                                                **shape), reps=3, warmup=1)
    slic_peak = torch.cuda.max_memory_allocated()
    del lab, c0, c3, labels, images
    torch.cuda.empty_cache()

    # K = 990 on 2 frames, a ragged H*W, every window empty
    images = torch.from_numpy(frames_full[:2, :1000, :1998]).to(dev)
    lab, c0, kshape = slic_inputs(images, 1000, comp)
    far = c0.clone()
    far[..., 3] += 10 * kshape["height"]
    c2 = sweeps(c0, 2, kshape)
    checks.update({"k990_ragged_grid": assign_check(lab, c0, kshape),
                   "k990_ragged_after_2_sweeps": assign_check(lab, c2,
                                                              kshape),
                   "empty_windows": assign_check(lab, far, kshape)})
    k990 = c0.shape[1]
    del lab, c0, c2, far, images
    torch.cuda.empty_cache()

    # the two engines where the Lloyd kernel takes the shape
    images = torch.from_numpy(frames512[:30]).to(dev)
    lab, c0, shape512 = slic_inputs(images, seg, comp)
    lloyd = slic_fused.slic_lloyd(lab, c0, n_iter=n_iter, **shape512)
    sweep = slic_per_sweep(lab, c0, n_iter=n_iter, **shape512)
    engines_err = int((lloyd.long() - sweep.long()).abs().max())
    lloyd_ms, _ = cuda_ms(lambda: slic_fused.slic_lloyd(
        lab, c0, n_iter=n_iter, **shape512), reps=5)
    sweep_ms, _ = cuda_ms(lambda: slic_per_sweep(
        lab, c0, n_iter=n_iter, **shape512), reps=5)
    lloyd_least, lloyd_by = lloyd_bound_ms(lab, c0, shape512, n_iter)[:2]
    cluster = slic_fused.cluster_size(30, shape512["height"],
                                      shape512["width"])
    del lab, c0, lloyd, sweep, images
    torch.cuda.empty_cache()

    out = {"phase": "slic_assign", "images": len(frames_full),
           "hw": list(FULL_HW), "centres": k, "k990_centres": k990,
           "k990_hw": [1000, 1998], "strip": list(sa.STRIP),
           "max_abs_err": {n: c[0] for n, c in checks.items()},
           "labels_in_range": {n: c[1] for n, c in checks.items()},
           "sums_equal": {n: c[2] for n, c in checks.items()},
           "kernel_ms": kernel_ms, "kernel_runs_ms": kernel_runs,
           "plain_ms": plain_ms, "bound_ms": least_ms,
           "bound_by": bound_by, "bytes": n_bytes, "operations": n_ops,
           "sums_ms": sums_ms, "sums_runs_ms": sums_runs,
           "sums_plain_ms": plain_sums_ms,
           "sums_bound_ms": sums_least_ms, "sums_bound_by": sums_by,
           "sums_bytes": sums_bytes, "sums_operations": sums_ops,
           "window_pairs_per_pixel": n_ops / 10 / (len(frames_full)
                                                   * FULL_HW[0] * FULL_HW[1]),
           "update_ms": update, "update_reductions_equal": same_sums,
           "per_sweep_slic_ms": slic_ms,
           "per_sweep_split_ms": split,
           "per_sweep_peak_memory_bytes": slic_peak,
           "engines_512x1024": {"images": 30, "max_abs_err": engines_err,
                                "lloyd_ms": lloyd_ms,
                                "lloyd_bound_ms": lloyd_least,
                                "lloyd_bound_by": lloyd_by,
                                "lloyd_cluster": cluster,
                                "per_sweep_ms": sweep_ms}}
    emit(out)
    for name, (err, in_range, sums_equal) in checks.items():
        check(err == 0, f"slic_assign bit-equal to its plain version: "
                        f"{name}")
        check(in_range, f"slic_assign labels in [0, K): {name}")
        check(sums_equal, f"fused sums equal bincount's: {name}")
    check(engines_err == 0, "per-sweep engine equals the Lloyd kernel")
    check(same_sums, "fused, index_add_ and bincount sums agree")
    return out


def reset_counts():
    from spalign_tpu_torch.kernels import pooling, slic_assign, slic_fused

    slic_fused.slic_lloyd.launches = 0
    slic_assign.slic_assign.launches = 0
    slic_assign.slic_assign.sums_launches = 0
    pooling.reset_launches()


def read_counts():
    from spalign_tpu_torch.kernels import pooling, slic_assign, slic_fused

    return {"slic_lloyd": slic_fused.slic_lloyd.launches,
            "slic_assign": slic_assign.slic_assign.launches,
            "slic_assign_sums": slic_assign.slic_assign.sums_launches,
            "pool2x2": pooling.pool2x2.launches,
            "scatter2x2": pooling.scatter2x2.launches,
            "gather2x2": pooling.gather2x2.launches}


def stage_seconds(records, per):
    """Mean host seconds per unit (every ``per`` records) by stage."""
    return {key[5:]: float(np.mean([r[key] for r in records[::per]]))
            for key in records[0] if key.startswith("time_")}


def overlaps_phase(frames_full, labels_full):
    """The overlaps mode on the 1024x2048 frames, batch 30."""
    import torch

    from spalign_tpu_torch import native
    from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig
    from spalign_tpu_torch.pipeline.direct import make_label_generator
    from spalign_tpu_torch.pipeline.wire import pack_yuv420

    sp = SuperpixelConfig(method="slic", n_slic_segments=100, slic_iters=10,
                          slic_enforce_connectivity=False)
    cfg = LabelGenConfig(mode="overlaps", batchsize=30,
                         upload_format="yuv420", save_masks=False,
                         overlap_threshold=0.01, superpixel=sp)
    t0 = time.time()
    frames = native.resize_cubic_u8(frames_full, cfg.resize_shape)
    t_resize = time.time() - t0
    n = len(frames_full)
    gen = make_label_generator(cfg)
    gen.process_dataset(Frames(frames, labels_full, n, full=frames_full),
                        save=False)
    timed = Frames(frames, labels_full, OVERLAPS_BATCHES * n,
                   full=frames_full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    records = gen.process_dataset(timed, save=False)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    ious = [r["road_iou"] for r in records]
    predicted = [r["TP"] + r["FP"] for r in records]
    road, _, diag, _ = gen.run_batch(frames, full_images=frames_full)
    road_shape = list(road.shape)
    t0 = time.time()
    packed = native.pack_yuv420(frames_full)
    t_pack = time.time() - t0
    t0 = time.time()
    plain = pack_yuv420(frames_full)
    t_pack_plain = time.time() - t0

    half = make_label_generator(dataclasses.replace(
        cfg, superpixel=dataclasses.replace(sp, slic_device_downscale=2)))
    road2, _, _, _ = half.run_batch(frames, full_images=frames_full)
    block = road2[:, ::2, ::2].repeat_interleave(2, 1).repeat_interleave(
        2, 2)
    out = {"phase": "overlaps_path", "images": len(records),
           "batches": OVERLAPS_BATCHES, "batch": n,
           "full_hw": list(FULL_HW), "seconds": elapsed,
           "images_per_s": len(records) / elapsed,
           "batch_stage_seconds": stage_seconds(records, n),
           "launches": counts, "peak_memory_bytes": peak,
           "mean_road_iou": float(np.mean(ious)),
           "min_predicted_road_px": int(min(predicted)),
           "n_superpixels": diag["n_superpixels"][0],
           "mask_shape": road_shape, "resize_seconds": t_resize,
           "full_frame_pack_seconds": t_pack,
           "full_frame_pack_plain_seconds": t_pack_plain,
           "full_frame_pack_equal": bool(np.array_equal(packed, plain)),
           "downscale2_mask_shape": list(road2.shape),
           "downscale2_block_constant": bool(torch.equal(road2, block))}
    emit(out)
    check(len(records) == OVERLAPS_BATCHES * n, "one record per image")
    check(counts["slic_assign"] == 11 * OVERLAPS_BATCHES
          and counts["slic_assign_sums"] == 10 * OVERLAPS_BATCHES,
          f"11 assignment launches a batch, 10 sums-only, got {counts}")
    check(min(predicted) > 0, "no all-empty road mask")
    check(all(np.isfinite(ious)), "finite road IoU")
    check(road_shape == [n, *FULL_HW], "full-resolution masks")
    check(out["full_frame_pack_equal"], "C++ pack equals the numpy pack")
    check(out["downscale2_mask_shape"] == [n, *FULL_HW]
          and out["downscale2_block_constant"],
          "slic_device_downscale=2: 2x2-block-constant full-res masks")
    return out


def direct_phase(frames, labels):
    """The direct mode at the bench unit."""
    import torch

    from spalign_tpu_torch.config import LabelGenConfig
    from spalign_tpu_torch.pipeline.direct import make_label_generator

    cfg = LabelGenConfig(mode="direct", batchsize=30, groups_per_dispatch=5,
                         upload_format="yuv420", save_masks=False)
    gen = make_label_generator(cfg)
    gen.process_dataset(Frames(frames, labels, UNIT), save=False)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    records = gen.process_dataset(Frames(frames, labels, 3 * UNIT),
                                  save=False)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    ious = [r["road_iou"] for r in records]
    out = {"phase": "direct_path", "images": len(records), "units": 3,
           "seconds": elapsed, "images_per_s": len(records) / elapsed,
           "unit_stage_seconds": stage_seconds(records, UNIT),
           "mean_road_iou": float(np.mean(ious)),
           "min_predicted_road_px": int(min(r["TP"] + r["FP"]
                                            for r in records)),
           "kmeans_iters": sorted({r["kmeans_iters"] for r in records}),
           "launches": read_counts()}
    emit(out)
    check(len(records) == 3 * UNIT, "one record per image")
    check(all(np.isfinite(ious)), "finite road IoU")
    return out


def cli_phase():
    """The label_gen CLI in-process: overlaps on 4 synthetic scenes."""
    from spalign_tpu_torch.cli import label_gen

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    t0 = time.time()
    records = label_gen.main([
        "--mode", "overlaps", "--synthetic", "4", "--synthetic_shape",
        str(FULL_HW[0]), str(FULL_HW[1]), "--superpixel_method", "slic",
        "--slic_no_connectivity", "--out_dir", out_dir])
    elapsed = time.time() - t0
    with open(os.path.join(out_dir, "summary.txt")) as f:
        summary = f.read()
    out = {"phase": "cli", "records": len(records), "seconds": elapsed,
           "summary": summary.splitlines()}
    emit(out)
    check(len(records) == 4, "one record per scene")
    check(all(np.isfinite(r["road_iou"]) for r in records), "finite IoU")
    return out


def drive(gen, dataset):
    """``gen.process_dataset`` with every kernel count set to 0 just
    before and read just after: (records, seconds, launches)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    records = gen.process_dataset(dataset, save=False)
    torch.cuda.synchronize()
    return records, time.time() - t0, read_counts()


def drive_summary(gen, dataset, per):
    """``drive`` and what a phase reports of the run: images/s, host
    seconds by stage per ``per`` records, superpixel counts, mean road
    IoU, launches."""
    records, elapsed, launches = drive(gen, dataset)
    counts = np.concatenate([r["n_superpixels"] for r in records[::per]])
    return records, {
        "images": len(records), "seconds": elapsed,
        "images_per_s": len(records) / elapsed,
        "stage_seconds": stage_seconds(records, per),
        "superpixel_counts": {"min": int(counts.min()),
                              "median": float(np.median(counts)),
                              "max": int(counts.max())},
        "mean_road_iou": float(np.mean([r["road_iou"] for r in records])),
        "launches": launches}


def host_library_phase(frames, labels, frames_full, cfg):
    """The host library: felzenszwalb of golden_frames() against the JAX
    package's constant, the native scorer against its plain version on
    the spalign path's 512x1024 labels, and their times."""
    from spalign_tpu_torch import native
    from spalign_tpu_torch.pipeline.label_gen import (host_confusion,
                                                      host_confusion_reference)

    frames = golden_frames()
    maps = felzenszwalb_maps(native.felzenszwalb, frames)
    rng = np.random.RandomState(0)
    masks = rng.rand(len(labels), *cfg.resize_shape) < 0.4
    t0 = time.perf_counter()
    confs = [host_confusion(m, lab) for m, lab in zip(masks, labels)]
    score_ms = (time.perf_counter() - t0) / len(labels) * 1e3
    t0 = time.perf_counter()
    want = [host_confusion_reference(m, lab) for m, lab in zip(masks, labels)]
    plain_ms = (time.perf_counter() - t0) / len(labels) * 1e3
    same_conf = all(np.array_equal(a, b) for a, b in zip(confs, want))

    def felz_ms(batch):
        t0 = time.perf_counter()
        felzenszwalb_maps(native.felzenszwalb, batch)
        return (time.perf_counter() - t0) / len(batch) * 1e3

    out = {"phase": "host_library", "cpu_count": os.cpu_count(),
           "golden_frames_sha256": sha256(frames),
           "golden_maps_sha256": sha256(maps),
           "golden_counts": (maps.max(axis=(1, 2)) + 1).tolist(),
           "felzenszwalb_params": list(FELZENSZWALB_PARAMS),
           "felzenszwalb_ms_per_image_224": felz_ms(frames[:30]),
           "felzenszwalb_ms_per_image_1024x2048": felz_ms(frames_full[:4]),
           "scorer_images": len(labels), "scorer_hw": list(labels.shape[1:]),
           "scorer_ms_per_image": score_ms,
           "plain_scorer_ms_per_image": plain_ms,
           "scorer_equals_plain": same_conf}
    emit(out)
    check(out["golden_frames_sha256"] == GOLDEN_FRAMES_SHA256,
          "golden frames as made on the machine that fixed the constant")
    check(out["golden_maps_sha256"] == GOLDEN_MAPS_SHA256,
          "felzenszwalb maps equal the JAX package's library's")
    check(same_conf, "native scorer equals the plain scorer")
    return out



def align_chunking(frames, cfg):
    """superpixel_align at the default felzenszwalb unit's shapes (150
    images, S = max_superpixels, 10 anchors, 28x28x512 features, the
    frames' felzenszwalb maps): device ms (CUDA events, median of 5),
    host ms per call and peak memory, chunked as the port runs it and
    in one chunk of the whole unit (the align before the chunking);
    the two results must be equal."""
    import torch

    from spalign_tpu_torch.ops import align
    from spalign_tpu_torch.pipeline.superpixels import compute_superpixels

    dev = torch.device("cuda")
    unit = frames[np.arange(UNIT) % len(frames)]
    sps, _ = compute_superpixels(unit, cfg.superpixel, device=dev)
    sps = torch.from_numpy(sps.astype(np.int32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    fmaps = torch.randn((UNIT, 28, 28, 512), generator=g, device=dev)
    s = cfg.superpixel.max_superpixels

    def run():
        return align.superpixel_align(fmaps, sps, cfg.align.n_anchors, s,
                                      generator=torch.Generator(
                                          device=dev).manual_seed(1))

    out, results = {}, {}
    default = align.ALIGN_CHUNK_BYTES
    for name, budget in (("chunked", default), ("one_chunk", 1 << 50)):
        align.ALIGN_CHUNK_BYTES = budget
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            results[name] = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms, _ = cuda_ms(run, reps=5)
            t0 = time.perf_counter()
            run()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            out[name] = {"images_per_chunk": align.align_chunk(
                s, cfg.align.n_anchors, 512), "device_ms": ms,
                "host_ms_per_call": host_ms, "peak_bytes": peak}
        finally:
            align.ALIGN_CHUNK_BYTES = default
        torch.cuda.empty_cache()
    out["equal"] = all(torch.equal(a, b) for a, b in zip(
        results["chunked"], results["one_chunk"]))
    return out

def host_superpixels_phase(frames, labels):
    """SpalignLabelGenerator with the default SuperpixelConfig()
    (felzenszwalb 300 / 0.8 / 20, max_superpixels 1024) at the bench unit
    on the rgb8 wire: a warm-up unit, 3 timed units and their peak device
    memory; then one unit with SLIC + the connectivity pass, and one
    default unit at max_superpixels S_LARGE."""
    import torch

    from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator

    cfg = LabelGenConfig(batchsize=30, groups_per_dispatch=5,
                         upload_format="rgb8", save_masks=False)
    gen = SpalignLabelGenerator(cfg)
    gen.process_dataset(Frames(frames, labels, UNIT), save=False)
    torch.cuda.reset_peak_memory_stats()
    records, timed = drive_summary(gen, Frames(frames, labels, 3 * UNIT),
                                   UNIT)
    peak = torch.cuda.max_memory_allocated()
    predicted = [r["TP"] + r["FP"] for r in records]
    del gen
    torch.cuda.empty_cache()

    gen = SpalignLabelGenerator(dataclasses.replace(
        cfg, superpixel=SuperpixelConfig(method="slic", n_slic_segments=100,
                                         slic_iters=10)))
    slic_records, slic = drive_summary(gen, Frames(frames, labels, UNIT),
                                       UNIT)
    del gen
    torch.cuda.empty_cache()

    # the align chunked over images: one default unit at S = 4096
    gen = SpalignLabelGenerator(dataclasses.replace(
        cfg, superpixel=SuperpixelConfig(max_superpixels=S_LARGE)))
    torch.cuda.reset_peak_memory_stats()
    large_records, large = drive_summary(gen, Frames(frames, labels, UNIT),
                                         UNIT)
    large["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del gen
    torch.cuda.empty_cache()
    chunking = align_chunking(frames, cfg)
    out = {"phase": "host_superpixels_path", "units": 3, "unit": UNIT,
           "wire": cfg.upload_format,
           "superpixel": dataclasses.asdict(cfg.superpixel), **timed,
           "min_predicted_road_px": int(min(predicted)),
           "retries": int(sum(r["retries"] for r in records[::UNIT])),
           "peak_memory_bytes": peak,
           "peak_memory_bytes_before_chunking": PEAK_BEFORE_CHUNKING,
           "align_chunking": chunking, "slic_connectivity": slic,
           f"max_superpixels_{S_LARGE}": large}
    emit(out)
    check(peak < PEAK_BEFORE_CHUNKING,
          "the chunked align lowers the default unit's peak")
    check(chunking["equal"], "the chunked align equals one chunk")
    check(len(large_records) == UNIT
          and all(np.isfinite(r["road_iou"]) for r in large_records),
          f"a unit at max_superpixels {S_LARGE} completes")
    check(len(records) == 3 * UNIT, "one record per image")
    check(min(predicted) > 0, "no all-empty road mask")
    check(all(np.isfinite(r["road_iou"]) for r in records + slic_records),
          "finite road IoU")
    check(timed["superpixel_counts"]["max"]
          <= cfg.superpixel.max_superpixels, "counts within max_superpixels")
    check(slic["launches"]["slic_lloyd"] > 0,
          "SLIC + connectivity launched the Lloyd kernel")
    return out


def parity_phase(frames):
    """One batch of 30 at 224^2 in the bit-parity mode (felzenszwalb,
    float32 DRN) on the card, and its parity stages re-run on the CPU
    from the card's features and maps with fresh replicas of the same
    streams: only the Lloyd loop's device differs."""
    import torch

    from spalign_tpu_torch.config import KMeansConfig, LabelGenConfig
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator
    from spalign_tpu_torch.utils.timers import StageTimer

    cfg = LabelGenConfig(batchsize=30, upload_format="rgb8",
                         save_masks=False, kmeans=KMeansConfig(
                             init="reference"))
    batch = frames[:30]
    gen = SpalignLabelGenerator(cfg)
    features = []
    real_features = gen.features

    def keep_features(images):
        out = real_features(images)
        features.append(out)
        return out

    gen.features = keep_features
    torch.cuda.synchronize()
    reset_counts()
    timers = StageTimer()
    t0 = time.time()
    card = gen._host_prepare(batch, None, timers)  # run_batch, in parts
    handles = gen.dispatch_batch(card, timers)
    road, cluster, diag = gen.finish_batch(card, handles, timers)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = read_counts()
    cluster = cluster.cpu().numpy()

    cpu = SpalignLabelGenerator(cfg, device="cpu")
    cpu.features = lambda images: features[0].cpu()
    prepared = cpu._host_prepare(batch)
    t0 = time.time()
    for _ in range(diag["retries"] + 1):  # the card's inits, in order
        plain = cpu.run_parity(prepared, StageTimer())
    cpu_seconds = time.time() - t0
    plain_cluster = plain["cluster"].numpy()
    differ = int((plain_cluster != cluster).sum())
    out = {"phase": "parity_path", "images": len(batch),
           "seconds": elapsed, "stage_seconds": {
               k[5:]: v for k, v in timers.times.items()},
           "features_dtype": str(features[0].dtype)[6:],
           "n_superpixels": {"min": min(diag["n_superpixels"]),
                             "max": max(diag["n_superpixels"])},
           "kmeans_iters": diag["_per_group"]["kmeans_iters"],
           "retries": diag["retries"], "road_px": int(road.sum()),
           "cpu_rerun_seconds": cpu_seconds,
           "cluster_pixels_differing_from_cpu": differ,
           "superpixels_equal": bool(np.array_equal(
               prepared["sps_host"], card["sps_host"])),
           "launches": launches}
    emit(out)
    check(out["features_dtype"] == "float32", "float32 features")
    check(out["superpixels_equal"], "the CPU re-run has the card's maps")
    check(differ == 0, "card cluster maps equal the CPU re-run's")
    return out


def overlaps_felzenszwalb_phase(frames_full, labels_full):
    """The overlaps mode with felzenszwalb of the 1024x2048 frames (the
    reference's default frontend), batch 30: max_superpixels set to the
    largest count the frames give, a warm-up and a timed batch; then one
    batch with SLIC + the connectivity pass."""
    from spalign_tpu_torch import native
    from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig
    from spalign_tpu_torch.pipeline.direct import make_label_generator
    from spalign_tpu_torch.pipeline.superpixels import compute_superpixels

    n = len(frames_full)
    sp = SuperpixelConfig(max_superpixels=2 ** 20)
    t0 = time.time()
    _, counts = compute_superpixels(frames_full, sp)
    t_counts = time.time() - t0
    bound = int(counts.max())
    cfg = LabelGenConfig(mode="overlaps", batchsize=n, save_masks=False,
                         superpixel=dataclasses.replace(
                             sp, max_superpixels=bound))
    frames = native.resize_cubic_u8(frames_full, cfg.resize_shape)
    dataset = Frames(frames, labels_full, n, full=frames_full)
    gen = make_label_generator(cfg)
    gen.process_dataset(dataset, save=False)
    records, timed = drive_summary(gen, dataset, n)
    predicted = [r["TP"] + r["FP"] for r in records]
    del gen

    gen = make_label_generator(dataclasses.replace(
        cfg, superpixel=SuperpixelConfig(method="slic", n_slic_segments=100,
                                         slic_iters=10)))
    slic_records, slic = drive_summary(gen, dataset, n)
    out = {"phase": "overlaps_felzenszwalb_path", "batch": n,
           "full_hw": list(FULL_HW),
           "superpixel": dataclasses.asdict(cfg.superpixel),
           "max_superpixels": bound, "counting_seconds": t_counts, **timed,
           "min_predicted_road_px": int(min(predicted)),
           "slic_connectivity": slic}
    emit(out)
    check(len(records) == n, "one record per image")
    check(min(predicted) > 0, "no all-empty road mask")
    check(all(np.isfinite(r["road_iou"]) for r in records + slic_records),
          "finite road IoU")
    check(records[0]["n_superpixels"] == counts.tolist(),
          "records carry the felzenszwalb counts")
    check(slic["launches"]["slic_assign"] == 11
          and slic["launches"]["slic_assign_sums"] == 10,
          f"SLIC + connectivity at 1024x2048: 11 assignment launches, "
          f"got {slic['launches']}")
    return out



def write_fake_cityscapes(root):
    """REAL_SCENES synthetic scenes at 1024x2048 written by the port's PNG
    encoder as a Cityscapes tree (leftImg8bit/train/<city>/..., gtFine/
    train/<city>/...) and its image and label zips; the first VAL_FRAMES
    again as the val zips.  Returns (frames, labelIds, paths, seconds
    to make the scenes, seconds to encode and zip them)."""
    import zipfile

    from spalign_tpu_torch.data.png import encode_png
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

    ds = SyntheticRoadScenes(n=REAL_SCENES, full_shape=FULL_HW, seed=29)
    t0 = time.time()
    with ThreadPoolExecutor(8) as pool:
        items = list(pool.map(ds.__getitem__, range(REAL_SCENES)))
    t_scenes = time.time() - t0
    keys = [f"{CITIES[i % len(CITIES)]}_000000_{i:06d}"
            for i in range(REAL_SCENES)]

    def write(i):
        img, lab = items[i]
        city = CITIES[i % len(CITIES)]
        out = []
        for sub, name, arr in (
                ("leftImg8bit", f"{keys[i]}_leftImg8bit.png", img),
                ("gtFine", f"{keys[i]}_gtFine_labelIds.png", lab)):
            member = f"{sub}/train/{city}/{name}"
            os.makedirs(os.path.join(root, os.path.dirname(member)),
                        exist_ok=True)
            with open(os.path.join(root, member), "wb") as f:
                f.write(encode_png(arr))
            out.append(member)
        return out

    t0 = time.time()
    with ThreadPoolExecutor(8) as pool:
        members = list(pool.map(write, range(REAL_SCENES)))
    paths = {}
    for name, idx, col in (("img_zip", REAL_SCENES, 0),
                           ("label_zip", REAL_SCENES, 1),
                           ("val_img_zip", VAL_FRAMES, 0),
                           ("val_label_zip", VAL_FRAMES, 1)):
        paths[name] = os.path.join(root, f"{name}.zip")
        with zipfile.ZipFile(paths[name], "w") as zf:
            for m in members[:idx]:
                zf.write(os.path.join(root, m[col]), m[col])
    paths["images"] = [os.path.join(root, m[0]) for m in members]
    paths["img_list"] = os.path.join(root, "images.txt")
    with open(paths["img_list"], "w") as f:
        f.write("\n".join(paths["images"][:LIST_FRAMES]) + "\n")
    t_write = time.time() - t0
    frames = np.stack([im for im, _ in items])
    labels = np.stack([lab for _, lab in items])
    return frames, labels, paths, t_scenes, t_write


def unit_stages(records, per):
    """Host seconds by stage of the last unit of ``per`` records."""
    last = records[-min(per, len(records))]
    return {k[5:]: last[k] for k in last if k.startswith("time_")}


def real_files_phase():
    """Real image files: a fake Cityscapes tree of PNGs read through the
    port's CLIs.  The label CLI on the directory (the default
    configuration: felzenszwalb), on the zip pair with SLIC + the
    connectivity pass (the Lloyd kernel) and on an image file list
    without labels (PNG masks); then the train CLI on the image zip and
    the directory run's masks at the reference recipe, evaluated on the
    val zips at 1024x2048.  Also the codec, the resize and the yuv420
    pack, each against its plain version, and their times."""
    import torch

    from spalign_tpu_torch import native
    from spalign_tpu_torch.cli import label_gen as label_cli
    from spalign_tpu_torch.cli import train as train_cli
    from spalign_tpu_torch.data.png import decode_png
    from spalign_tpu_torch.kernels import pooling as pk
    from spalign_tpu_torch.pipeline import wire

    root = tempfile.mkdtemp(prefix="chip_smoke_real_")
    frames, labels, paths, t_scenes, t_write = write_fake_cityscapes(root)

    # the codec and the resize, per frame, against the frames
    def decode(i):
        with open(paths["images"][i], "rb") as f:
            return decode_png(f.read())

    t0 = time.time()
    with ThreadPoolExecutor(8) as pool:
        decoded = list(pool.map(decode, range(REAL_SCENES)))
    decode_ms = (time.time() - t0) / REAL_SCENES * 1e3
    t0 = time.time()
    decode(0)
    decode_ms_one_thread = (time.time() - t0) * 1e3
    round_trip = all(np.array_equal(a, b) for a, b in zip(decoded, frames))
    t0 = time.time()
    native.resize_cubic_u8(frames[:1], (224, 224))
    resize_ms_one_thread = (time.time() - t0) * 1e3
    t0 = time.time()
    small = native.resize_cubic_u8(frames, (224, 224))
    resize_ms = (time.time() - t0) / REAL_SCENES * 1e3
    resize_equal = np.array_equal(
        small[:2], np.stack([native.resize_cubic_u8_reference(f, (224, 224))
                             for f in frames[:2]]))
    golden = sha256(native.resize_cubic_u8(golden_frames(), (224, 224)))

    # the yuv420 pack of a unit (150 at 224^2) and of a full-frame batch
    unit = small[np.arange(UNIT) % REAL_SCENES]
    packs = {}
    for name, batch in (("unit_150x224", unit),
                        ("batch_30x1024x2048", frames[:30])):
        t0 = time.time()
        got = native.pack_yuv420(batch)
        t_native = time.time() - t0
        t0 = time.time()
        want = wire.pack_yuv420(batch)
        packs[name] = {"seconds": t_native,
                       "plain_seconds": time.time() - t0,
                       "equal": bool(np.array_equal(got, want))}
    del decoded, small, unit

    # the label CLI on the directory, the zip pair and a file list
    runs = {}
    dir_out = os.path.join(root, "labels_dir")
    for name, args in (
            ("dir_felzenszwalb",
             ["--cityscapes_dir", root, "--split", "train",
              "--out_dir", dir_out]),
            ("zip_slic_connectivity",
             ["--cityscapes_img_zip", paths["img_zip"],
              "--cityscapes_label_zip", paths["label_zip"],
              "--superpixel_method", "slic",
              "--out_dir", os.path.join(root, "labels_zip")]),
            ("file_list_no_labels",
             ["--img_file_list", paths["img_list"],
              "--out_dir", os.path.join(root, "labels_list")])):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        records = label_cli.main(args)
        torch.cuda.synchronize()
        runs[name] = {"images": len(records),
                      "seconds": time.time() - t0,
                      "launches": read_counts(),
                      "last_unit_stage_seconds": unit_stages(records, 30)}
        if "road_iou" in records[0]:
            runs[name]["mean_road_iou"] = float(np.mean(
                [r["road_iou"] for r in records]))
    masks_equal = []
    for fn in paths["images"][:LIST_FRAMES]:
        base = os.path.join(root, "labels_list", os.path.basename(fn))
        with open(base, "rb") as f:
            mask = decode_png(f.read(), color=False)
        masks_equal.append(np.array_equal(mask,
                                          np.load(base[:-4] + ".npy")))

    # the train CLI on the image zip and the directory run's masks
    torch.cuda.synchronize()
    pk.reset_launches()
    t0 = time.time()
    trainer, evaluator = train_cli.main([
        "--train_img_zip", paths["img_zip"], "--train_label_zip", dir_out,
        "--val_img_zip", paths["val_img_zip"], "--val_label_zip",
        paths["val_label_zip"], "--optimizer", "Adam", "--batchsize", "8",
        "--input_shape", "512", "1024", "--eval_shape", "1024", "2048",
        "--train_limit", str(REAL_TRAIN_STEPS), "--log_interval", "1",
        "--val_interval", str(REAL_TRAIN_STEPS),
        "--result_dir", os.path.join(root, "train")])
    torch.cuda.synchronize()
    t_train = time.time() - t0
    train_launches = {"pool2x2": pk.pool2x2.launches,
                      "scatter2x2": pk.scatter2x2.launches,
                      "gather2x2": pk.gather2x2.launches}
    with open(os.path.join(root, "train", "log")) as f:
        log = json.load(f)
    steps = [r for r in log if "main/loss" in r]
    val = [r for r in log if "val/main/loss" in r]
    # ms per step over the steps after the first two (the first step of
    # a new model tunes cuDNN), from the trainer's own clock
    ms_per_step = ((steps[-1]["elapsed_time"] - steps[1]["elapsed_time"])
                   / (len(steps) - 2) * 1e3)
    out = {"phase": "real_files", "scenes": REAL_SCENES,
           "full_hw": list(FULL_HW), "scene_seconds": t_scenes,
           "write_seconds": t_write,
           "zip_bytes": {k: os.path.getsize(v) for k, v in paths.items()
                         if k.endswith("_zip")},
           "decode_ms_per_frame_8_threads": decode_ms,
           "decode_ms_per_frame_one_thread": decode_ms_one_thread,
           "decode_round_trip_equal": round_trip,
           "resize_ms_per_frame_8_threads": resize_ms,
           "resize_ms_per_frame_one_thread": resize_ms_one_thread,
           "resize_equals_plain": bool(resize_equal),
           "golden_resize_sha256": golden,
           "yuv420_pack": packs, "label_cli": runs,
           "no_label_png_masks": len(masks_equal),
           "no_label_png_masks_equal": all(masks_equal),
           "train_steps": trainer.step, "train_seconds": t_train,
           "train_ms_per_step": ms_per_step,
           "train_losses": [r["main/loss"] for r in steps],
           "train_launches": train_launches, "val": val[-1] if val else None}
    emit(out)
    paths["labels_dir"] = dir_out
    paths["train_dir"] = os.path.join(root, "train")
    check(round_trip, "decode(encode(frame)) == frame")
    check(resize_equal, "resize equals its plain version")
    check(golden == GOLDEN_RESIZE_SHA256, "golden resize hash")
    check(all(v["equal"] for v in packs.values()),
          "C++ yuv420 pack equals the numpy pack")
    check(runs["dir_felzenszwalb"]["images"] == REAL_SCENES
          and runs["zip_slic_connectivity"]["images"] == REAL_SCENES
          and runs["file_list_no_labels"]["images"] == LIST_FRAMES,
          "the label CLI labels every frame of each source")
    check(runs["zip_slic_connectivity"]["launches"]["slic_lloyd"] > 0,
          "the zip run launched the Lloyd kernel")
    check(all(masks_equal) and len(masks_equal) == LIST_FRAMES,
          "PNG masks equal the .npy masks without labels")
    check(trainer.step == REAL_TRAIN_STEPS, "the train CLI ran its steps")
    check(all(np.isfinite(r["main/loss"]) for r in steps), "finite losses")
    check(evaluator is not None and val
          and all(np.isfinite(v) for v in val[-1].values()),
          "finite val metrics at 1024x2048")
    check(all(v > 0 for v in train_launches.values()),
          f"the train CLI launched the pooling kernels: {train_launches}")
    return out, paths


def pooling_counts():
    from spalign_tpu_torch.kernels import pooling as pk

    return {"pool2x2": pk.pool2x2.launches,
            "scatter2x2": pk.scatter2x2.launches,
            "gather2x2": pk.gather2x2.launches}


def relabel_summary(records, seconds, batch):
    """Images/s of a relabel run, its mean host seconds per batch by
    stage (every ``batch`` records share their batch's stages) and the
    mean road IoU of its PREDs against the gt."""
    per_batch = records[::batch]
    return {"images": len(records), "seconds": seconds,
            "images_per_s": len(records) / seconds,
            "batch_stage_seconds": {
                k[5:]: float(np.mean([r[k] for r in per_batch]))
                for k in records[0] if k.startswith("time_")},
            "mean_road_iou": float(np.mean([r["road_iou"]
                                            for r in records]))}


def read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def ch1_is_one_minus_ch0(path):
    """Every ``*_scores`` member of the zip at ``path`` has channel 1
    equal to 1 - channel 0 bit for bit; returns the members checked."""
    from spalign_tpu_torch import native

    n = 0
    with np.load(path) as npz:
        for k in npz.files:
            if not k.endswith("_scores"):
                continue
            s = npz[k]
            want = (native.one_minus_f16_reference(s[0])
                    if s.dtype == np.float16
                    else (1.0 - s[0].astype(np.float32)).astype(s.dtype))
            check(np.array_equal(s[1].view(np.uint8), want.view(np.uint8)),
                  f"{k}: channel 1 == 1 - channel 0 bit for bit")
            n += 1
    return n


def selftrain_phase(paths):
    """Two self-training rounds on real_files' fake Cityscapes tree at the
    reference recipe (the label CLI's masks as the initial labels; soft
    loss, so round 2 reads round 1's float16 network-resolution scores),
    then the relabel CLI on round 2's snapshot in the reference's disk
    format, held to a CPU re-run of 2 frames."""
    import torch

    from spalign_tpu_torch.config import RoundsConfig, TrainConfig
    from spalign_tpu_torch.data.cityscapes import ZippedCityscapesRoadDataset
    from spalign_tpu_torch.data.estimated import EstimatedCityscapesDataset
    from spalign_tpu_torch.kernels import pooling as pk
    from spalign_tpu_torch.models.segnet import build_segnet
    from spalign_tpu_torch.selftrain import RoundsDriver
    from spalign_tpu_torch.selftrain import rounds as rounds_mod
    from spalign_tpu_torch.selftrain.relabel import relabel_dataset
    from spalign_tpu_torch.selftrain.rounds import _Subset
    from spalign_tpu_torch.train.checkpoints import (find_snapshot,
                                                     load_predictor)
    from spalign_tpu_torch.data.loader import PrefetchLoader
    from spalign_tpu_torch.train.evaluator import Evaluator
    from spalign_tpu_torch.train.trainer import Trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_selftrain_")
    input_hw = TRAIN_HW
    cfg = RoundsConfig(n_round=SELFTRAIN_ROUNDS, iteration=ROUND_STEPS,
                       val_iteration=ROUND_STEPS, loss="soft", batchsize=8,
                       result_base_dir=root, eval_shape=FULL_HW,
                       score_dtype="float16", score_store="network")
    tcfg = TrainConfig(model="basic", optimizer="Adam",
                       input_shape=input_hw, eval_shape=FULL_HW,
                       compute_dtype="float32")

    def make_train_dataset(label_source, use_soft):
        return EstimatedCityscapesDataset(
            paths["img_zip"], label_source or paths["labels_dir"], input_hw,
            use_soft_label=use_soft)

    def make_relabel_dataset():
        return ZippedCityscapesRoadDataset(paths["img_zip"],
                                           paths["label_zip"], input_hw)

    stamps = []  # (step, seconds) at the end of every train step

    class StepClock(Trainer):
        def train_step(self, images, labels):
            out = super().train_step(images, labels)
            torch.cuda.synchronize()
            stamps.append((self.step, time.perf_counter()))
            return out

    class TimedRounds(RoundsDriver):
        """The driver with a clock around each round's training and
        relabel."""
        seconds = {}

        def _timed(self, key, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.seconds[key] = time.perf_counter() - t0
            return out

        def _train_round(self, n_round, label_source, resume_state=None):
            return self._timed(f"train_round{n_round}", super()._train_round,
                               n_round, label_source, resume_state)

        def _relabel(self, n_round, result_dir):
            return self._timed(f"relabel_round{n_round}", super()._relabel,
                               n_round, result_dir)

    val_ds = ZippedCityscapesRoadDataset(paths["val_img_zip"],
                                         paths["val_label_zip"], input_hw)

    def evaluator_factory(trainer):
        # the val zips evaluated at the eval shape each round (the
        # rounds' logs then carry the road IoU that make_table reads)
        return Evaluator(trainer.model, lambda: iter(PrefetchLoader(
            val_ds, cfg.batchsize, shuffle=False, epochs=1,
            drop_last=False)), FULL_HW, device="cuda")

    driver = TimedRounds(cfg, tcfg, make_train_dataset, make_relabel_dataset,
                         evaluator_factory=evaluator_factory)
    rounds_mod.Trainer = StepClock
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launches()
        t0 = time.time()
        final_dir, final_zip = driver.run()
        torch.cuda.synchronize()
        t_rounds = time.time() - t0
        launches = pooling_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        rounds_mod.Trainer = Trainer

    rounds = []
    for k in range(1, SELFTRAIN_ROUNDS + 1):
        it = ROUND_STEPS * k
        steps = [t for s, t in stamps if it - ROUND_STEPS < s <= it]
        rdir = os.path.join(root, f"train_round{k}")
        zip_path = os.path.join(rdir, f"iter-{it}_eval-train.0.zip")
        records = read_records(os.path.join(rdir, f"iter-{it}_eval-train",
                                            "result.json"))
        with open(os.path.join(rdir, "log")) as f:
            val = [e for e in json.load(f) if "val/main/iou/road" in e
                   and it - ROUND_STEPS < e["iteration"] <= it]
        rounds.append({
            "val_batches": len(val) * -(-VAL_FRAMES // cfg.batchsize),
            "val_road_iou": val[-1]["val/main/iou/road"] if val else None,
            "loss": "ce" if k == 1 else cfg.loss,
            "train_seconds": driver.seconds[f"train_round{k}"],
            # steps 3-10 of the round (its first steps tune cuDNN)
            "train_ms_per_step": (steps[-1] - steps[1]) / (len(steps) - 2)
            * 1e3,
            "relabel": relabel_summary(
                records, driver.seconds[f"relabel_round{k}"], cfg.batchsize),
            "zip_bytes": os.path.getsize(zip_path),
            "score_members_checked": ch1_is_one_minus_ch0(zip_path)})
    r1_zip = os.path.join(root, "train_round1",
                          f"iter-{ROUND_STEPS}_eval-train.0.zip")
    round2_reader = EstimatedCityscapesDataset(
        paths["img_zip"], r1_zip, input_hw, use_soft_label=True)

    # the relabel CLI on round 2's snapshot, in the reference's format
    cli_out = os.path.join(root, "relabel_cli")
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "spalign_tpu_torch.cli.relabel",
         "--param_dir", final_dir, "--img_zip_fn", paths["img_zip"],
         "--label_zip_fn", paths["label_zip"], "--out_dir", cli_out,
         "--soft_label", "--score_store", "eval", "--score_dtype",
         "float32"], cwd=repo, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": repo})
    t_cli = time.time() - t0
    check(proc.returncode == 0,
          f"cli.relabel exited {proc.returncode}: {proc.stderr[-2000:]}")
    said = re.search(r"in ([0-9.]+) s \(([0-9.]+) images/s\)", proc.stdout)
    check(said is not None, f"cli.relabel's summary: {proc.stdout[-500:]}")
    cli_zip = cli_out + ".0.zip"
    cli_records = read_records(os.path.join(cli_out, "result.json"))
    cli = relabel_summary(cli_records, float(said.group(1)), cfg.batchsize)
    cli.update({"process_seconds": t_cli, "zip_bytes":
                os.path.getsize(cli_zip),
                "score_members_checked": ch1_is_one_minus_ch0(cli_zip)})

    # the first frames of the CLI's output against a CPU re-run
    cpu_zip = os.path.join(root, "relabel_cpu.0.zip")
    t0 = time.time()
    relabel_dataset(build_segnet("basic", device="cpu"),
                    load_predictor(find_snapshot(final_dir)),
                    _Subset(make_relabel_dataset(), CPU_FRAMES), cpu_zip,
                    eval_shape=FULL_HW, batch_size=CPU_FRAMES,
                    score_dtype=np.float32, device="cpu")
    t_cpu = time.time() - t0
    agree, score_err = [], []
    with np.load(cpu_zip) as cpu, np.load(cli_zip) as card:
        for k in cpu.files:
            if k.endswith("_scores"):
                score_err.append(np.abs(cpu[k] - card[k]))
            else:
                agree.append(float(np.mean(cpu[k] == card[k])))
    score_err = np.stack(score_err)

    paths["rounds_dir"] = root
    out = {"phase": "selftrain", "frames": len(round2_reader),
           "input_shape": list(input_hw), "eval_shape": list(FULL_HW),
           "rounds": rounds, "rounds_seconds": t_rounds,
           "final_dir_steps": stamps[-1][0], "launches": launches,
           "peak_memory_bytes": peak, "relabel_cli": cli,
           "cpu_rerun": {"frames": CPU_FRAMES, "seconds": t_cpu,
                         "pred_agreement": agree,
                         "score_max_abs_err": float(score_err.max()),
                         "score_mean_abs_err": float(score_err.mean()),
                         "score_share_above_1e-3":
                         float((score_err > 1e-3).mean())}}
    emit(out)
    steps_run = SELFTRAIN_ROUNDS * ROUND_STEPS
    relabel_batches = SELFTRAIN_ROUNDS * -(-REAL_SCENES // cfg.batchsize)
    forwards = relabel_batches + sum(r["val_batches"] for r in rounds)
    check(launches == {"pool2x2": 4 * (steps_run + forwards),
                       "scatter2x2": 8 * steps_run + 4 * forwards,
                       "gather2x2": 4 * steps_run},
          f"pooling launches of {steps_run} steps and {forwards} relabel "
          f"and val batches, got {launches}")
    check(all(r["val_batches"] > 0 and np.isfinite(r["val_road_iou"])
              for r in rounds), "each round evaluated on the val zips")
    check(final_zip == os.path.join(
        final_dir, f"iter-{steps_run}_eval-train.0.zip"), "round 2's zip")
    check(all(r["relabel"]["images"] == REAL_SCENES for r in rounds)
          and cli["images"] == REAL_SCENES, "every frame relabeled")
    check(all(r["score_members_checked"] == REAL_SCENES for r in rounds)
          and cli["score_members_checked"] == REAL_SCENES,
          "a score member per frame")
    check(len(round2_reader) == REAL_SCENES,
          "round 2's reader pairs round 1's zip with every frame")
    check(all(np.isfinite(r["relabel"]["mean_road_iou"]) for r in rounds),
          "finite road IoU")
    check(min(agree) >= 0.999, f"PREDs agree with the CPU on >= 0.999: "
          f"{agree}")
    # the mean, not the max: SegNet's argmax pooling is discontinuous, and
    # a pooling window whose values lie within float32 noise of each other
    # moves the scores around it when the two devices round differently
    check(float(score_err.mean()) <= 1e-3,
          f"scores within 1e-3 of the CPU on average: {score_err.mean()}")
    return out


def avih_frames(path) -> int:
    """dwTotalFrames of an AVI's main header (avih)."""
    with open(path, "rb") as f:
        head = f.read(4096)
    i = head.index(b"avih")
    return struct.unpack("<I", head[i + 8 + 16:i + 8 + 20])[0]


def workflow_phase(paths):
    """The README's remaining tools on what real_files and selftrain
    wrote: convert_model (card against CPU), make_zips, bottom_half
    (against a numpy recompute), mean_result (against
    aggregate_results), make_table --plot, then demo_video from the train
    CLI's snapshot over DEMO_FRAMES frames at the reference shapes, its
    pool and scatter launches counted exactly and its first masks held to
    a CPU re-run."""
    import zipfile

    import torch

    from spalign_tpu_torch import native
    from spalign_tpu_torch.cli import (bottom_half, convert_model,
                                       demo_video, make_table, make_zips,
                                       mean_result)
    from spalign_tpu_torch.data.cityscapes import (CITYSCAPES_MEAN,
                                                   CITYSCAPES_STD)
    from spalign_tpu_torch.data.labels import create_label_mask
    from spalign_tpu_torch.data.png import decode_png
    from spalign_tpu_torch.eval.results import aggregate_results, read_results
    from spalign_tpu_torch.kernels import pooling as pk
    from spalign_tpu_torch.models.drn import DRN_FACTORIES
    from spalign_tpu_torch.models.segnet import build_segnet, predict_labels
    from spalign_tpu_torch.train.checkpoints import (find_snapshot,
                                                     load_predictor)
    from spalign_tpu_torch.utils.video import MJPG_QUALITY

    work = tempfile.mkdtemp(prefix="chip_smoke_workflow_")
    root = os.path.dirname(paths["img_zip"])
    out = {"phase": "workflow"}

    # 1. convert_model on a seed-0 DRN's .pth, the card against the CPU
    pth = os.path.join(work, "drn_c_26_seed0.pth")
    torch.save(DRN_FACTORIES["drn_c_26"](device="cpu").state_dict(), pth)
    t0 = time.time()
    worst = convert_model.main([pth, os.path.join(work, "drn_port.pth"),
                                "--check", "--device", "cuda"])
    out["convert_model"] = {"seconds": time.time() - t0,
                            "max_abs_delta": worst}

    # 2. make_zips of the val images (the first VAL_FRAMES of the tree)
    val_zip = os.path.join(work, "val_imgs.0.zip")
    make_zips.main(["dir", os.path.join(
        root, "leftImg8bit", "train", "*",
        f"*_00000[0-{VAL_FRAMES - 1}]_leftImg8bit.png"), val_zip])
    with zipfile.ZipFile(val_zip) as zf:
        out["make_zips_members"] = len(zf.namelist())

    # 3. bottom_half on the val zips against a numpy recompute
    agg = bottom_half.main(["--cityscapes_img_zip", paths["val_img_zip"],
                            "--cityscapes_label_zip",
                            paths["val_label_zip"], "--device", "cuda"])
    ious = []
    with zipfile.ZipFile(paths["val_label_zip"]) as zf:
        for name in zf.namelist():
            gt = create_label_mask(decode_png(zf.read(name), color=False))
            pred = np.zeros_like(gt)
            pred[gt.shape[0] // 2:] = 1
            tp = int(((pred == 1) & (gt == 1)).sum())
            fp = int(((pred == 1) & (gt == 0)).sum())
            fn = int(((pred == 0) & (gt == 1)).sum())
            # float32 IoUs, averaged in float64 (aggregate_results)
            ious.append(float(np.float32(tp) / np.float32(tp + fp + fn)))
    out["bottom_half"] = {"road_mean_iou": agg["road_mean_iou"],
                          "numpy_road_mean_iou": float(np.mean(ious)),
                          "n": agg["n"]}

    # 4. mean_result on the label CLI's result.json
    result_json = os.path.join(paths["labels_dir"], "result.json")
    summary = mean_result.main([result_json])
    summary_equal = summary == aggregate_results(read_results(result_json))

    # 5. make_table --plot on the rounds
    csv, pdf = make_table.main([paths["rounds_dir"], "--plot"])
    with open(csv) as f:
        table_rows = len(f.read().splitlines()) - 1
    with open(pdf, "rb") as f:
        pdf_head = f.read(9)
    out["make_table"] = {"rows": table_rows, "pdf_bytes":
                         os.path.getsize(pdf)}

    # 6. demo_video from the train CLI's snapshot at the reference shapes
    frames_dir = os.path.join(work, "frames")
    os.makedirs(frames_dir)
    for fn in paths["images"][:DEMO_FRAMES]:
        os.symlink(fn, os.path.join(frames_dir, os.path.basename(fn)))
    demo_dir = os.path.join(work, "demo")
    torch.cuda.synchronize()
    pk.reset_launches()
    demo = demo_video.main([
        "--param_dir", paths["train_dir"], "--frames_dir", frames_dir,
        "--out_dir", demo_dir, "--input_shape", *map(str, TRAIN_HW),
        "--pred_shape", *map(str, FULL_HW), "--batchsize", str(DEMO_BATCH),
        "--device", "cuda"])
    torch.cuda.synchronize()
    demo["launches"] = pooling_counts()
    avi = os.path.join(demo_dir, "demo.avi")
    demo["avih_total_frames"] = avih_frames(avi)
    batches = -(-DEMO_FRAMES // DEMO_BATCH)

    # the JPEG encoder on one 2 MP frame, against its numpy reference
    with open(paths["images"][0], "rb") as f:
        frame = decode_png(f.read())
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        jpeg = native.encode_jpeg_rgb(frame, MJPG_QUALITY)
        runs.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    jpeg_equal = jpeg == native.encode_jpeg_rgb_reference(frame,
                                                          MJPG_QUALITY)
    demo["jpeg"] = {"ms_per_2mp_frame": float(np.median(runs)),
                    "runs_ms": runs, "bytes": len(jpeg),
                    "reference_ms": (time.perf_counter() - t0) * 1e3,
                    "equals_reference": jpeg_equal}

    # the first masks against a CPU re-run
    model = build_segnet("basic", device="cpu")
    model.load_state_dict(load_predictor(find_snapshot(paths["train_dir"])))
    raw = []
    for fn in paths["images"][:CPU_FRAMES]:
        with open(fn, "rb") as f:
            raw.append(decode_png(f.read()))
    small = native.resize_cubic_u8(np.stack(raw), TRAIN_HW)
    batch = (small.astype(np.float32) - CITYSCAPES_MEAN) / CITYSCAPES_STD
    t0 = time.time()
    cpu = predict_labels(model, torch.from_numpy(batch),
                         pred_shape=FULL_HW).numpy()
    agree = [float(np.mean(cpu[b] == np.load(os.path.join(
        demo_dir, os.path.basename(fn)[:-4] + ".npy"))))
        for b, fn in enumerate(paths["images"][:CPU_FRAMES])]
    demo["cpu_rerun"] = {"frames": CPU_FRAMES, "seconds": time.time() - t0,
                         "mask_agreement": agree}
    out["demo_video"] = demo
    emit(out)
    check(worst is not None and worst <= 1e-3,
          "convert_model's check passed on the card")
    check(out["make_zips_members"] == VAL_FRAMES, "make_zips member count")
    check(agg["n"] == VAL_FRAMES and abs(
        agg["road_mean_iou"] - float(np.mean(ious))) <= 1e-9,
          "bottom_half's IoU equals the numpy recompute")
    check(summary_equal, "mean_result's summary equals aggregate_results")
    check(table_rows == SELFTRAIN_ROUNDS, "a make_table row a round")
    check(pdf_head == b"%PDF-1.4\n", "the plot's PDF header")
    check(demo["frames"] == DEMO_FRAMES
          and demo["avih_total_frames"] == DEMO_FRAMES,
          "demo_video wrote every frame")
    check(len([f for f in os.listdir(demo_dir) if f.endswith(".npy")])
          == DEMO_FRAMES, "a mask a frame")
    check(demo["launches"] == {"pool2x2": 4 * batches,
                               "scatter2x2": 4 * batches, "gather2x2": 0},
          f"demo_video's pooling launches: {demo['launches']}")
    check(jpeg_equal, "the JPEG encoder equals its numpy reference")
    check(min(agree) >= 0.999, f"demo masks agree with the CPU: {agree}")
    return out


def sweep_phase(frames, labels):
    """cli/sweep.py in-process on main_path's frames, one unit a value:
    fig 7 (k = 2..8) on the device-SLIC unit, which launches the Lloyd
    kernel, and fig 9's felzenszwalb scale at 100, 300 and 800 on the
    default unit; then a dynamic-k generator against fresh static ones
    on one seed stream, k = 2 and 8."""
    import torch

    from spalign_tpu_torch.cli import sweep as sweep_cli
    from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator

    work = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    dataset = Frames(frames, labels, UNIT)
    grids = {}
    build = sweep_cli.build_label_dataset
    sweep_cli.build_label_dataset = lambda args, hw: dataset
    try:
        for name, flags in (
                ("fig7_device_slic",
                 ["--grid", "fig7", "--superpixel_method", "slic",
                  "--slic_no_connectivity", "--n_slic_segments", "100",
                  "--max_superpixels", "256", "--upload_format", "yuv420"]),
                ("fig9_felzenszwalb",
                 ["--grid", "custom", "--param",
                  "superpixel.felzenszwalb_scale", "--values", "100", "300",
                  "800"])):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.time()
            rows = sweep_cli.main(flags + [
                "--batchsize", "30", "--groups_per_dispatch", "5",
                "--sweep_out", os.path.join(work, f"{name}.csv"),
                "--out_dir", os.path.join(work, name), "--device", "cuda"])
            torch.cuda.synchronize()
            grids[name] = {
                "seconds": time.time() - t0, "launches": read_counts(),
                "rows": [{"value": v, "images": agg["n"], "seconds": sec,
                          "images_per_s": agg["n"] / sec,
                          "road_iou": agg["road_mean_iou"]}
                         for v, agg, _, sec in rows]}
    finally:
        sweep_cli.build_label_dataset = build

    cfg = LabelGenConfig(
        batchsize=30, upload_format="yuv420", save_masks=False,
        superpixel=SuperpixelConfig(method="slic", n_slic_segments=100,
                                    max_superpixels=256,
                                    slic_enforce_connectivity=False))
    dyn = SpalignLabelGenerator(cfg, dynamic_k=8)
    batch = frames[:cfg.batchsize]
    dynamic_equal = {}
    for k in (2, 8):
        dyn.set_n_clusters(k)
        static = SpalignLabelGenerator(dataclasses.replace(
            cfg, kmeans=dataclasses.replace(cfg.kmeans, n_clusters=k)))
        dyn._seed_rng = np.random.RandomState(123)
        static._seed_rng = np.random.RandomState(123)
        _, c_dyn, _, _ = dyn.run_batch(batch)
        _, c_static, _, _ = static.run_batch(batch)
        dynamic_equal[k] = bool(torch.equal(c_dyn, c_static))
        del static
    out = {"phase": "sweep", "grids": grids,
           "dynamic_equals_static": dynamic_equal}
    emit(out)
    fig7 = grids["fig7_device_slic"]
    check([r["value"] for r in fig7["rows"]] == list(range(2, 9))
          and all(r["images"] == UNIT for g in grids.values()
                  for r in g["rows"]), "one unit a value")
    check(fig7["launches"]["slic_lloyd"] >= len(fig7["rows"]),
          f"fig 7 launched the Lloyd kernel: {fig7['launches']}")
    check(all(np.isfinite(r["road_iou"]) for g in grids.values()
              for r in g["rows"]), "finite road IoU")
    check(all(dynamic_equal.values()), f"dynamic k equals static k on the "
          f"card: {dynamic_equal}")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def data_parallel_phase():
    """DP_STEPS train steps of the reference recipe under a one-rank NCCL
    group against the same steps without a group, from the same weights
    and batches: bit-equal parameters, BN running statistics and losses."""
    import torch
    import torch.distributed as dist

    from spalign_tpu_torch.config import TrainConfig
    from spalign_tpu_torch.kernels import pooling as pk
    from spalign_tpu_torch.pipeline.label_gen import nn_resize_np
    from spalign_tpu_torch.train.trainer import Trainer

    imgs, gts = val_batch()
    labels = nn_resize_np(gts, TRAIN_HW)
    batches = [(np.roll(imgs, k, 0), np.roll(labels, k, 0))
               for k in range(DP_STEPS)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    cfg = TrainConfig(model="basic", batchsize=8, input_shape=TRAIN_HW,
                      optimizer="Adam", loss="ce", result_dir=tmp)

    def run():
        trainer = Trainer(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [trainer.train_step(*trainer.to_device(*b))["loss"]
                  for b in batches]
        torch.cuda.synchronize()
        return (trainer, [float(v) for v in losses],
                {k: v.clone() for k, v in trainer.model.state_dict().items()},
                time.perf_counter() - t0)

    # deterministic cuDNN algorithms, so that two runs can be bit-equal
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    try:
        _, want_losses, want, t_plain = run()
        os.environ.update(env)
        dist.init_process_group("nccl", init_method="env://", rank=0,
                                world_size=1)
        try:
            pk.reset_launches()
            trainer, got_losses, got, t_group = run()
            launches = pooling_counts()
            ones = torch.ones(4, device=trainer.device)
            dist.all_reduce(ones)
            backend = dist.get_backend()
            world = trainer.world
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for k in env:
            os.environ.pop(k, None)
    equal = {k: bool(torch.equal(got[k], v)) for k, v in want.items()}
    out = {"phase": "data_parallel", "backend": backend, "world_size": world,
           "device": str(trainer.device), "steps": DP_STEPS,
           "losses": got_losses, "losses_without_group": want_losses,
           "state_tensors": len(equal),
           "state_tensors_bit_equal": sum(equal.values()),
           "seconds_with_group": t_group,
           "seconds_without_group": t_plain, "launches": launches,
           "all_reduce_of_ones": ones.tolist()}
    emit(out)
    check(backend == "nccl" and world == 1, "a one-rank NCCL group")
    check(ones.tolist() == [1.0] * 4, "NCCL all-reduce on one rank")
    check(got_losses == want_losses, "losses bit-equal without a group")
    check(all(equal.values()),
          f"parameters and BN statistics bit-equal: "
          f"{[k for k, v in equal.items() if not v]}")
    check(launches == {"pool2x2": 4 * DP_STEPS, "scatter2x2": 8 * DP_STEPS,
                       "gather2x2": 4 * DP_STEPS},
          f"4, 8 and 4 pooling launches a step, got {launches}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from spalign_tpu_torch import native
    from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig
    from spalign_tpu_torch.kernels import pooling, slic_assign, slic_fused
    from spalign_tpu_torch.kernels.slic import slic_inputs
    from spalign_tpu_torch.models.drn import (DRN_FACTORIES,
                                              preprocess_imagenet)
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator
    from spalign_tpu_torch.pipeline.wire import decode_yuv420

    t_start = time.time()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    libs = [slic_fused.LIBRARY, slic_assign.LIBRARY, pooling.LIBRARY,
            native.LIBRARY]
    t0 = time.time()
    build_libraries(libs)
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "libraries": [{"source": "spalign_tpu_torch/csrc/"
                                   + lib.source.name,
                         "compiler": lib.compiler().rsplit("/", 1)[-1],
                         "seconds": lib.build_seconds,
                         "ptxas": ptxas_lines(lib)} for lib in libs]})

    # --- the kernel against its plain version, at the main path's inputs
    cfg = LabelGenConfig(
        batchsize=30, groups_per_dispatch=5, upload_format="yuv420",
        save_masks=False,
        superpixel=SuperpixelConfig(method="slic", n_slic_segments=100,
                                    slic_iters=10, max_superpixels=256,
                                    slic_enforce_connectivity=False))
    sp = cfg.superpixel
    t0 = time.time()
    frames512, labels = make_scenes()
    frames = native.resize_cubic_u8(frames512, cfg.resize_shape)
    t_scenes = time.time() - t0
    unit = frames[np.arange(UNIT) % len(frames)]
    wire = torch.from_numpy(native.pack_yuv420(unit)).to(dev)
    images = decode_yuv420(wire, cfg.resize_shape)
    lab, c0, shape = slic_inputs(images, sp.n_slic_segments,
                                 sp.slic_compactness)
    kw = dict(shape, n_iter=sp.slic_iters)
    got = slic_fused.slic_lloyd(lab, c0, **kw)
    torch.cuda.synchronize()
    want = slic_fused.slic_lloyd_reference(lab, c0, **kw)
    torch.cuda.synchronize()
    k = c0.shape[1]
    max_abs_err = int((got.long() - want.long()).abs().max())
    in_range = bool(((got >= 0) & (got < k)).all())
    kernel_ms, kernel_runs = cuda_ms(
        lambda: slic_fused.slic_lloyd(lab, c0, **kw), reps=20)
    plain_ms, _ = cuda_ms(
        lambda: slic_fused.slic_lloyd_reference(lab, c0, **kw), reps=3,
        warmup=1)
    lloyd_ms, lloyd_by, n_bytes, n_ops = lloyd_bound_ms(
        lab, c0, shape, sp.slic_iters)
    lloyd = {"phase": "slic_lloyd", "images": UNIT,
             "hw": list(cfg.resize_shape), "centres": k,
             "sweeps": sp.slic_iters, "strip": list(slic_assign.STRIP),
             "cluster": slic_fused.cluster_size(UNIT, *cfg.resize_shape),
             "max_abs_err": max_abs_err, "labels_in_range": in_range,
             "kernel_ms": kernel_ms, "kernel_runs_ms": kernel_runs,
             "plain_ms": plain_ms, "bound_ms": lloyd_ms,
             "bound_by": lloyd_by, "bytes": n_bytes, "operations": n_ops,
             "scene_seconds": round(t_scenes, 3)}
    emit(lloyd)
    check(max_abs_err == 0, "Lloyd kernel bit-equal to its plain version")
    check(in_range, "labels in [0, K)")

    # --- the assignment kernel at the overlaps path's inputs
    t0 = time.time()
    frames_full, labels_full = make_full_scenes()
    t_full_scenes = time.time() - t0
    assign = slic_assign_phase(frames_full, frames512, sp)

    # --- the main path: SpalignLabelGenerator at the bench configuration
    gen = SpalignLabelGenerator(cfg)
    warm = Frames(frames, labels, UNIT)
    gen.process_dataset(warm, save=False)
    timed = Frames(frames, labels, 3 * UNIT)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    records = gen.process_dataset(timed, save=False)
    elapsed = time.time() - t0
    launches = read_counts()["slic_lloyd"]
    check(len(records) == 3 * UNIT, "one record per image")
    ious = [r["road_iou"] for r in records]
    predicted_road = [r["TP"] + r["FP"] for r in records]
    groups = {}
    for i, r in enumerate(records):
        groups[i // cfg.batchsize] = r["kmeans_iters"]
    # host wall-clock seconds per unit by stage (stages of a unit overlap
    # other units' work: load/upload run on the producer thread)
    stages = {key[5:]: float(np.mean([r[key] for r in records[::UNIT]]))
              for key in records[0] if key.startswith("time_")}
    with torch.no_grad():
        feats = gen.features(images[:cfg.batchsize])
    main = {"phase": "main_path", "images": len(records), "units": 3,
            "seconds": elapsed, "images_per_s": len(records) / elapsed,
            "mean_road_iou": float(np.mean(ious)),
            "kmeans_iters_per_group": list(groups.values()),
            "retries": int(sum(r["retries"] for r in records[::UNIT])),
            "slic_lloyd_launches": launches,
            "unit_stage_seconds": stages,
            "min_predicted_road_px": int(min(predicted_road)),
            "features_shape": list(feats.shape),
            "features_finite": bool(torch.isfinite(feats).all()),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(main)
    check(launches > 0, "the main path launched the Lloyd kernel")
    check(min(predicted_road) > 0, "no all-empty road mask")
    check(main["features_finite"], "finite features")
    check(all(np.isfinite(ious)), "finite road IoU")

    # --- bf16 (the bench dtype) against float32 features, same weights
    f32 = DRN_FACTORIES["drn_c_26"]().to(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = f32.features(preprocess_imagenet(images[:cfg.batchsize]))
    diff = float((feats - ref).abs().max())
    emit({"phase": "features", "bf16_vs_f32_max_abs": diff,
          "f32_max_abs": float(ref.abs().max()),
          "relative": diff / float(ref.abs().max())})

    del f32, ref, gen
    torch.cuda.empty_cache()

    # --- the overlaps and direct modes, and the CLI
    overlaps = overlaps_phase(frames_full, labels_full)
    direct_phase(frames, labels)
    cli_phase()
    torch.cuda.empty_cache()

    # --- the host library, the host superpixel engines, the parity mode
    host_library_phase(frames, labels, frames_full, cfg)
    host_sp = host_superpixels_phase(frames, labels)
    parity_phase(frames)
    overlaps_felz = overlaps_felzenszwalb_phase(frames_full, labels_full)
    del frames_full, labels_full
    torch.cuda.empty_cache()

    # --- stage 2: the pooling kernels, then SegNetBasic training
    pool_summary = pooling_phase()
    train_launches = train_phase(cfg, frames, frames512, labels,
                                 pool_summary)
    torch.cuda.empty_cache()

    # --- real image files through the label and train CLIs
    real, real_paths = real_files_phase()
    torch.cuda.empty_cache()

    # --- self-training rounds and the relabel CLI on those files, then
    # the train step under a one-rank NCCL group
    selftrain = selftrain_phase(real_paths)
    torch.cuda.empty_cache()
    dp = data_parallel_phase()
    torch.cuda.empty_cache()

    # --- the README's remaining tools, then the ablation sweeps
    workflow = workflow_phase(real_paths)
    torch.cuda.empty_cache()
    sweep = sweep_phase(frames, labels)

    # launches over every path that runs a kernel, each path's counts set
    # to 0 just before it and read just after
    lloyd_paths = {"main_path": launches,
                   "host_superpixels_path.slic_connectivity":
                   host_sp["slic_connectivity"]["launches"]["slic_lloyd"],
                   "real_files.zip_slic_connectivity":
                   real["label_cli"]["zip_slic_connectivity"]["launches"][
                       "slic_lloyd"],
                   "sweep.fig7": sweep["grids"]["fig7_device_slic"][
                       "launches"]["slic_lloyd"]}
    assign_paths = {
        "overlaps_path": overlaps["launches"],
        "overlaps_felzenszwalb_path.slic_connectivity":
        overlaps_felz["slic_connectivity"]["launches"]}
    # slic_assign launches in two forms on the overlaps paths (labels once
    # a batch, sums-only n_iter times): its ms, plain_ms and bound_ms are
    # means over the paths' launches, each form weighted by its count
    n_sums = sum(c["slic_assign_sums"] for c in assign_paths.values())
    n_labels = sum(c["slic_assign"] for c in assign_paths.values()) - n_sums

    def per_launch(labels_key, sums_key):
        return ((n_labels * assign[labels_key] + n_sums * assign[sums_key])
                / (n_labels + n_sums))

    kernels = [{
        "name": "slic_lloyd", "route": "cuda",
        "source": "spalign_tpu_torch/csrc/slic_lloyd.cu",
        "replaces": "spalign_tpu/kernels/slic_fused.py:52",
        "launches": sum(lloyd_paths.values()),
        "launches_by_path": lloyd_paths, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": lloyd_ms, "bound_by": lloyd_by, "library_ms": None}, {
        "name": "slic_assign", "route": "cuda",
        "source": "spalign_tpu_torch/csrc/slic_assign.cu",
        "replaces": "spalign_tpu/kernels/experimental/slic_pallas.py:32",
        "launches": n_labels + n_sums,
        "launches_by_path": {k: c["slic_assign"]
                             for k, c in assign_paths.items()},
        "max_abs_err": max(assign["max_abs_err"].values()),
        "ms": per_launch("kernel_ms", "sums_ms"),
        "plain_ms": per_launch("plain_ms", "sums_plain_ms"),
        "bound_ms": per_launch("bound_ms", "sums_bound_ms"),
        "bound_by": (assign["sums_bound_by"] if n_sums >= n_labels
                     else assign["bound_by"]),
        "library_ms": None,
        "labels_launches": n_labels, "labels_ms": assign["kernel_ms"],
        "labels_plain_ms": assign["plain_ms"],
        "labels_bound_ms": assign["bound_ms"],
        "sums_launches": n_sums, "sums_ms": assign["sums_ms"],
        "sums_plain_ms": assign["sums_plain_ms"],
        "sums_bound_ms": assign["sums_bound_ms"],
        "bincount_ms": assign["update_ms"]["bincount_float64"]}]
    # pooling: sums over the train step's four float32 levels (one
    # launch of the kernel at each), launches over the timed steps of
    # train_path and the train CLI's run (its steps and its evaluation)
    for name, v in pool_summary.items():
        by_path = {"train_path": train_launches[name],
                   "real_files.train_cli": real["train_launches"][name],
                   "selftrain": selftrain["launches"][name],
                   "data_parallel": dp["launches"][name],
                   "workflow.demo_video":
                   workflow["demo_video"]["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda", "source": POOL_SOURCE,
            "replaces": POOL_REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": v["max_abs_err"], "ms": v["kernel_ms"],
            "kernel_ms": v["kernel_ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": v["library_ms"]})
    emit({"kernels": kernels, "full_scene_seconds": round(t_full_scenes, 3),
          "seconds": round(time.time() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
