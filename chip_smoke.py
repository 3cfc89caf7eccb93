"""Drive the PyTorch/CUDA port's label path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one CUDA GPU and
``nvcc``.  Phases, one JSON line each on stdout:

  device       the card (nvidia-smi name and power limit), CUDA, PyTorch
  build        nvcc build of csrc/slic_lloyd.cu and ptxas's resource use
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

then the ``kernels`` line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
then exits non-zero without the last line.  Without CUDA it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
N_SCENES = 30
UNIT = 150  # 5 groups x 30 images


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
    and their full-resolution labelIds."""

    def __init__(self, frames, labels, n):
        self.frames, self.labels, self.n = frames, labels, n

    def __len__(self):
        return self.n

    def image_name(self, i):
        return f"smoke_{i:06d}.png"

    def label_name(self, i):
        return f"smoke_{i:06d}_labelIds.png"

    def resized_batch(self, indices, hw):
        idx = [i % len(self.frames) for i in indices]
        return self.frames[idx], self.labels[idx]


def make_frames(hw):
    """30 synthetic scenes at 512x1024 and their mirror images: 60
    frames at ``hw`` with full-resolution labelIds."""
    from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

    ds = SyntheticRoadScenes(n=N_SCENES, full_shape=(512, 1024), seed=7)
    imgs, labels = ds.resized_batch(range(N_SCENES), hw)
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
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, n_ops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig
    from spalign_tpu_torch.kernels import slic_fused
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

    lib = slic_fused.LIBRARY
    t0 = time.time()
    lib.get()
    emit({"phase": "build", "source": "spalign_tpu_torch/csrc/slic_lloyd.cu",
          "seconds": round(time.time() - t0, 3),
          "nvcc_seconds": lib.build_seconds,
          "ptxas": [ln.strip() for ln in lib.build_log.splitlines()
                    if "Used" in ln or "spill" in ln]})

    # --- the kernel against its plain version, at the main path's inputs
    cfg = LabelGenConfig(
        batchsize=30, groups_per_dispatch=5, upload_format="yuv420",
        save_masks=False,
        superpixel=SuperpixelConfig(method="slic", n_slic_segments=100,
                                    slic_iters=10, max_superpixels=256,
                                    slic_enforce_connectivity=False))
    sp = cfg.superpixel
    t0 = time.time()
    frames, labels = make_frames(cfg.resize_shape)
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
    bound_ms, bound_by, n_bytes, n_ops = lloyd_bound_ms(
        lab, c0, shape, sp.slic_iters)
    lloyd = {"phase": "slic_lloyd", "images": UNIT,
             "hw": list(cfg.resize_shape), "centres": k,
             "sweeps": sp.slic_iters,
             "min_image_agreement": float(agreement.min()),
             "max_abs_err": max_abs_err, "labels_in_range": in_range,
             "kernel_ms": kernel_ms, "kernel_runs_ms": kernel_runs,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "bytes": n_bytes, "operations": n_ops,
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

    emit({"kernels": [{
        "name": "slic_lloyd", "route": "cuda",
        "source": "spalign_tpu_torch/csrc/slic_lloyd.cu",
        "replaces": "spalign_tpu/kernels/slic_fused.py:52",
        "launches": launches, "max_abs_err": max_abs_err,
        "agreement": float(agreement.min()),
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}],
        "seconds": round(time.time() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
