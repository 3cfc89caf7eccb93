"""Demo-video CLI: predict road masks for frames with a trained SegNet
and write the overlay video (replaces utils/create_demovideo.py +
utils/create_movie.py).

Counterpart of ``spalign_tpu/cli/demo_video.py`` with the same flags,
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
versions of the pooling kernels).  ``--param_dir`` is a training result
directory of the port (its ``args.txt`` and ``torch.save`` snapshots).
Each batch of frames decodes on a pool of threads (``data/png.py``),
resizes with cv2's cubic filter (``native.resize_cubic_u8``) and is
standardized with the Cityscapes statistics on a loader thread, one
batch ahead of the network; the SegNet forward runs in float32 (TF32
off), a short last batch padded with its last frame.  Writes a ``.npy``
uint8 mask per frame and the MJPG AVI (``utils/video.py``), and reports
the host seconds per batch by stage: decode, resize, forward, blend
(the road overlay), jpeg (the encoder), write (masks and the AVI).

Example:
  python -m spalign_tpu_torch.cli.demo_video --param_dir results/train \\
      --frames_dir data/cityscapes/leftImg8bit/demoVideo/stuttgart_00 \\
      --out_dir results/demo
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from spalign_tpu_torch import native
from spalign_tpu_torch.data.cityscapes import (CITYSCAPES_MEAN,
                                               CITYSCAPES_STD, _map_batch)
from spalign_tpu_torch.data.png import decode_png
from spalign_tpu_torch.models.segnet import build_segnet, predict_labels
from spalign_tpu_torch.train.checkpoints import find_snapshot, load_predictor
from spalign_tpu_torch.utils.device import full_float32, resolve_device
from spalign_tpu_torch.utils.timers import StageTimer
from spalign_tpu_torch.utils.video import write_overlay_video

STAGES = ("decode", "resize", "forward", "blend", "jpeg", "write")


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--param_dir", type=str, required=True)
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--frames_dir", type=str, required=True,
                   help="directory of frame .png images")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--out_video", type=str, default=None)
    p.add_argument("--input_shape", type=int, nargs=2,
                   default=[512, 1024])
    p.add_argument("--pred_shape", type=int, nargs=2,
                   default=[1024, 2048])
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without CUDA) or 'cpu'")
    return p.parse_args(argv)


def _read(fn):
    with open(fn, "rb") as f:
        return decode_png(f.read())


def main(argv=None):
    """Returns a summary: frames, seconds, frames/s, the AVI's bytes and
    the mean host seconds per batch by stage."""
    args = get_args(argv)
    dev = resolve_device(args.device)
    full_float32(dev)
    with open(os.path.join(args.param_dir, "args.txt")) as f:
        train_args = json.load(f)
    model = build_segnet(
        "basic" if train_args.get("model") == "basic" else "normal", 2,
        device=dev)
    model.load_state_dict(load_predictor(find_snapshot(args.param_dir,
                                                       args.iteration)))
    ih, iw = args.input_shape
    bs = args.batchsize
    frame_fns = sorted(glob.glob(os.path.join(args.frames_dir, "*.png")))
    chunks = [frame_fns[i:i + bs] for i in range(0, len(frame_fns), bs)]
    os.makedirs(args.out_dir, exist_ok=True)
    timers = StageTimer("demo.")

    def load(chunk):
        """(raw frames, the standardized padded batch, decode s, resize
        s), on the loader thread."""
        t0 = time.perf_counter()
        raw = _map_batch(_read, chunk)
        t1 = time.perf_counter()
        small = native.resize_cubic_u8(np.stack(raw), (ih, iw))
        batch = (small.astype(np.float32) - CITYSCAPES_MEAN) / CITYSCAPES_STD
        if len(chunk) < bs:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], bs - len(chunk), 0)])
        return raw, batch, t1 - t0, time.perf_counter() - t1

    def frames():
        with ThreadPoolExecutor(1) as loader:
            ahead = loader.submit(load, chunks[0]) if chunks else None
            for i, chunk in enumerate(chunks):
                raw, batch, t_decode, t_resize = ahead.result()
                if i + 1 < len(chunks):
                    ahead = loader.submit(load, chunks[i + 1])
                timers.add("decode", t_decode)
                timers.add("resize", t_resize)
                with timers.stage("forward"):  # .cpu() waits
                    labels = predict_labels(
                        model, torch.from_numpy(batch).to(dev),
                        pred_shape=tuple(args.pred_shape)).cpu().numpy()
                with timers.stage("write"):
                    for b, fn in enumerate(chunk):
                        base = os.path.splitext(os.path.basename(fn))[0]
                        np.save(os.path.join(args.out_dir, base),
                                labels[b].astype(np.uint8))
                for b in range(len(chunk)):
                    yield raw[b], labels[b]

    out_video = args.out_video or os.path.join(args.out_dir, "demo.avi")
    t0 = time.time()
    n = write_overlay_video(frames(), out_video, fps=args.fps, timers=timers)
    elapsed = time.time() - t0
    per_batch = {s: timers.times.get(f"time_{s}", 0.0) / max(len(chunks), 1)
                 for s in STAGES}
    print(f"wrote {n} frames to {out_video} (+ masks in {args.out_dir})")
    print(f"[demo_video] {n} frames in {elapsed:.3f} s "
          f"({n / max(elapsed, 1e-9):.3f} frames/s); host seconds a batch: "
          + ", ".join(f"{s} {v:.4f}" for s, v in per_batch.items()))
    return {"frames": n, "seconds": elapsed,
            "frames_per_s": n / max(elapsed, 1e-9),
            "avi_bytes": os.path.getsize(out_video) if n else 0,
            "batch_stage_seconds": per_batch}


if __name__ == "__main__":
    main()
