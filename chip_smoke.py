"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it: the label
path (stage 1), then SegNetBasic self-training on its labels (stage 2).

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA GPU and
``nvcc``.  Phases, one JSON line each on stdout:

  device       the card (nvidia-smi name and power limit), CUDA, PyTorch
  build        nvcc builds of csrc/slic_lloyd.cu and csrc/pooling.cu, run
               together, and ptxas's resource use per kernel
  slic_lloyd   the SLIC Lloyd kernel against its plain PyTorch version on
               the inputs the main path gives it (150 x 224^2, 100
               segments, 10 sweeps): labels must agree on > 0.995 of each
               image's pixels; times by CUDA events
  main_path    SpalignLabelGenerator at the bench configuration (DRN-C-26
               full width in bf16, 5 groups x 30 images per unit, yuv420
               wire, k=4, 10 anchors) over synthetic scenes with ground
               truth: a warm-up unit, then 3 timed units; every count set
               to 0 just before and read just after; the kernel must have
               launched, no road mask may be empty, no feature NaN
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

then the ``kernels`` line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
then exits non-zero without the last line.  Without CUDA it exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
N_SCENES = 30
UNIT = 150  # 5 groups x 30 images
# the SegNetBasic train step's pooling levels (B, H, W, C) at 512x1024
POOL_LEVELS = [(8, 512 >> i, 1024 >> i, 64) for i in range(4)]
SEGNET_SHAPE = (8, 64, 128, 512)  # SegNet's fourth block at 512x1024
TRAIN_WARMUP, TRAIN_TIMED = 2, 20
POOL_SOURCE = "spalign_tpu_torch/csrc/pooling.cu"
POOL_REPLACES = {"pool2x2": "spalign_tpu/kernels/pooling_pallas.py:83",
                 "scatter2x2": "spalign_tpu/kernels/pooling_pallas.py:119",
                 "gather2x2": "spalign_tpu/kernels/pooling_pallas.py:149"}


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


def make_scenes():
    """30 synthetic scenes at 512x1024 and their mirror images: 60 frames
    with their labelIds, both at 512x1024."""
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

    ds = SyntheticRoadScenes(n=N_SCENES, full_shape=(512, 1024), seed=7)
    imgs, labels = ds.resized_batch(range(N_SCENES), (512, 1024))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig
    from spalign_tpu_torch.data.synthetic import resize_bicubic_u8
    from spalign_tpu_torch.kernels import pooling, slic_fused
    from spalign_tpu_torch.kernels.slic import slic_inputs
    from spalign_tpu_torch.models.drn import (DRN_FACTORIES,
                                              preprocess_imagenet)
    from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator
    from spalign_tpu_torch.pipeline.wire import decode_yuv420, pack_yuv420

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

    libs = [slic_fused.LIBRARY, pooling.LIBRARY]
    t0 = time.time()
    build_libraries(libs)
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "libraries": [{"source": f"spalign_tpu_torch/csrc/{lib.name}.cu",
                         "nvcc_seconds": lib.build_seconds,
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
    frames = np.stack([resize_bicubic_u8(f, cfg.resize_shape)
                       for f in frames512])
    t_scenes = time.time() - t0
    unit = frames[np.arange(UNIT) % len(frames)]
    wire = torch.from_numpy(pack_yuv420(unit)).to(dev)
    images = decode_yuv420(wire, cfg.resize_shape)
    lab, c0, shape = slic_inputs(images, sp.n_slic_segments,
                                 sp.slic_compactness)
    kw = dict(shape, n_iter=sp.slic_iters)
    got = slic_fused.slic_lloyd(lab, c0, **kw)
    torch.cuda.synchronize()
    want = slic_fused.slic_lloyd_reference(lab, c0, **kw)
    torch.cuda.synchronize()
    k = c0.shape[1]
    agreement = (got == want).float().mean(1)
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
             "sweeps": sp.slic_iters,
             "min_image_agreement": float(agreement.min()),
             "max_abs_err": max_abs_err, "labels_in_range": in_range,
             "kernel_ms": kernel_ms, "kernel_runs_ms": kernel_runs,
             "plain_ms": plain_ms, "bound_ms": lloyd_ms,
             "bound_by": lloyd_by, "bytes": n_bytes, "operations": n_ops,
             "scene_seconds": round(t_scenes, 3)}
    emit(lloyd)
    check(float(agreement.min()) > 0.995, "kernel/plain label agreement")
    check(in_range, "labels in [0, K)")

    # --- the main path: SpalignLabelGenerator at the bench configuration
    gen = SpalignLabelGenerator(cfg)
    warm = Frames(frames, labels, UNIT)
    gen.process_dataset(warm, save=False)
    timed = Frames(frames, labels, 3 * UNIT)
    slic_fused.slic_lloyd.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    records = gen.process_dataset(timed, save=False)
    elapsed = time.time() - t0
    launches = slic_fused.slic_lloyd.launches
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

    del f32, ref
    torch.cuda.empty_cache()

    # --- stage 2: the pooling kernels, then SegNetBasic training
    pool_summary = pooling_phase()
    train_launches = train_phase(cfg, frames, frames512, labels,
                                 pool_summary)

    kernels = [{
        "name": "slic_lloyd", "route": "cuda",
        "source": "spalign_tpu_torch/csrc/slic_lloyd.cu",
        "replaces": "spalign_tpu/kernels/slic_fused.py:52",
        "launches": launches, "max_abs_err": max_abs_err,
        "agreement": float(agreement.min()),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": lloyd_ms, "bound_by": lloyd_by, "library_ms": None}]
    # pooling: sums over the train step's four float32 levels (one
    # launch of the kernel at each), launches over the timed steps
    for name, v in pool_summary.items():
        kernels.append({
            "name": name, "route": "cuda", "source": POOL_SOURCE,
            "replaces": POOL_REPLACES[name],
            "launches": train_launches[name],
            "max_abs_err": v["max_abs_err"], "ms": v["kernel_ms"],
            "kernel_ms": v["kernel_ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": v["library_ms"]})
    emit({"kernels": kernels, "seconds": round(time.time() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
