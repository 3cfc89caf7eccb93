"""Stage-by-stage exploration of the superpixel-align pipeline through
the port's APIs (the counterpart of ``examples/explore.py``): every
intermediate artifact of label generation on synthetic scenes -- input,
superpixel boundaries, the Gaussian road prior (pixel- and
superpixel-level), the joint k-means cluster map and the final road mask
-- as one 2x3 figure a scene, drawn with ``utils/viz.py`` and written as
PNG (``stages_<b>.png``).

Run:  python -m spalign_tpu_torch.examples.explore [--device cpu]
      [--out_dir DIR] [--seed N] [--images N]

The defaults are the JAX example's: 4 scenes of 512x1024 seen at
224x224, SLIC with 100 segments and 10 sweeps.  ``main`` returns the
figures' paths, each scene's road IoU against its ground truth and the
stage seconds.  The figure is drawn by hand (each stage repeated 2x2,
viridis, tab10 and grey as ``imshow`` colours them, 5x7 bitmap titles),
not by matplotlib.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from spalign_tpu_torch.config import LabelGenConfig, SuperpixelConfig
from spalign_tpu_torch.data.labels import create_label_mask
from spalign_tpu_torch.data.png import write_png
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.ops.prior import pixel_prior
from spalign_tpu_torch.ops.segments import segment_mean
from spalign_tpu_torch.pipeline.label_gen import (SpalignLabelGenerator,
                                                  _confusion_record,
                                                  host_confusion)
from spalign_tpu_torch.utils.timers import StageTimer
from spalign_tpu_torch.utils.viz import (MARGIN, colormap_viridis, compose,
                                         text_mask)

# matplotlib's tab10 (Colormap(bytes=True)); with vmin 0 and vmax 9 a
# cluster id v takes colour v
TAB10 = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44],
                  [214, 39, 40], [148, 103, 189], [140, 86, 75],
                  [227, 119, 194], [127, 127, 127], [188, 189, 34],
                  [23, 190, 207]], np.uint8)
BOUNDARY = np.array([255, 255, 0], np.uint8)
ZOOM = 2  # cells are the 224x224 stages repeated 2x2, so titles fit


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--out_dir", default="results/explore")
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--images", type=int, default=4,
                   help="scenes, one clustering group (default 4)")
    return p.parse_args(argv)


def boundaries(sp: np.ndarray) -> np.ndarray:
    """(H, W) bool: pixels whose lower or right neighbour has another
    superpixel id."""
    out = np.zeros(sp.shape, bool)
    out[:-1] |= sp[:-1] != sp[1:]
    out[:, :-1] |= sp[:, :-1] != sp[:, 1:]
    return out


def stage_figure(img, sp, prior_pix, cluster, road, iters, title):
    """The 2x3 figure of one scene under its title: input, superpixel
    boundaries, pixel prior, per-superpixel prior, clusters, road
    mask."""
    over = img.copy()
    over[boundaries(sp)] = BOUNDARY
    n_sp = int(sp.max()) + 1
    sp_prior = segment_mean(torch.from_numpy(prior_pix.reshape(-1)),
                            torch.from_numpy(sp.reshape(-1)),
                            n_sp).numpy()
    road_grey = np.repeat((road.astype(np.uint8) * 255)[..., None], 3, -1)
    h, w = sp.shape
    cells = [c.repeat(ZOOM, 0).repeat(ZOOM, 1) for c in (
        img, over, colormap_viridis(prior_pix),
        colormap_viridis(sp_prior[sp]), TAB10[np.clip(cluster, 0, 9)],
        road_grey)]
    titles = [f"input ({h}x{w})", f"SLIC superpixels (n={n_sp})",
              "pixel Gaussian road prior", "per-superpixel prior",
              f"joint k-means clusters (iters={iters})",
              "road mask (cluster 0)"]
    panel = compose(cells, titles, 3, (ZOOM * h, ZOOM * w))
    head = text_mask(title)[:, :panel.shape[1]]
    band = np.full((head.shape[0] + MARGIN, panel.shape[1], 3), 255,
                   np.uint8)
    x0 = (panel.shape[1] - head.shape[1]) // 2
    band[MARGIN:, x0:x0 + head.shape[1]][head] = 0
    return np.concatenate([band, panel])


def main(argv=None) -> dict:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    b_n = args.images
    cfg = LabelGenConfig(
        batchsize=b_n, resize_shape=(224, 224),
        superpixel=SuperpixelConfig(method="slic", n_slic_segments=100,
                                    slic_iters=10, max_superpixels=256),
        save_masks=False)
    scenes = SyntheticRoadScenes(n=b_n, full_shape=(512, 1024),
                                 seed=args.seed)
    imgs, labels = scenes.resized_batch(range(b_n), cfg.resize_shape)

    gen = SpalignLabelGenerator(cfg, device=args.device)
    timers = StageTimer()
    t0 = time.time()
    prepared = gen._host_prepare(imgs, None, timers)
    handles = gen.dispatch_batch(prepared, timers)
    road, cluster, diag = gen.finish_batch(prepared, handles, timers)
    seconds = time.time() - t0
    road, cluster = road.cpu().numpy(), cluster.cpu().numpy()
    sps = (prepared["sps_host"] if "sps_host" in prepared
           else handles["superpixels"].cpu().numpy())
    iters = diag["_per_group"]["kmeans_iters"][0]

    h, w = cfg.resize_shape
    prior_pix = pixel_prior(h, w, 0.75, 0.5, 0.1, 0.1,
                            device="cpu").numpy()
    paths, ious = [], []
    for b in range(b_n):
        gt = create_label_mask(labels[b])
        ious.append(_confusion_record(
            host_confusion(road[b], labels[b]))["road_iou"])
        fig = stage_figure(
            imgs[b], sps[b], prior_pix, cluster[b], road[b], iters,
            f"superpixel-align stages - scene {b} (GT road fraction "
            f"{float((gt == 1).mean()):.2f})")
        out = os.path.join(args.out_dir, f"stages_{b}.png")
        write_png(out, fig)
        paths.append(out)
        print(f"wrote {out}")
    stages = {k: round(v, 3) for k, v in timers.finish().items()}
    print(f"stage times: {stages}")
    return {"paths": paths, "road_iou": ious, "kmeans_iters": iters,
            "seconds": seconds, "stage_seconds": stages}


if __name__ == "__main__":
    main()
