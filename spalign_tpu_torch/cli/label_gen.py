"""Label-generation CLI: one tool, three modes.

Counterpart of ``spalign_tpu/cli/label_gen.py`` with the same flags and
defaults, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels).  Not ported: ``--profile_dir``, the
bit-parity k-means init, diagnostic panels (``--save_images``) and the
host superpixel engines (felzenszwalb, SLIC with connectivity), which
raise ``NotImplementedError``.

Example (data-free):
  python -m spalign_tpu_torch.cli.label_gen --mode overlaps --synthetic 4 \
      --superpixel_method slic --slic_no_connectivity --out_dir results/demo
"""

from __future__ import annotations

import argparse
import os

from spalign_tpu_torch.cli.common import (add_dataset_args,
                                          build_label_dataset,
                                          load_drn_weights)
from spalign_tpu_torch.config import (AlignConfig, KMeansConfig,
                                      LabelGenConfig, PriorConfig,
                                      SuperpixelConfig)
from spalign_tpu_torch.eval.results import read_results, write_summary


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="spalign",
                   choices=["spalign", "direct", "overlaps"])
    p.add_argument("--model", default="drn_c_26")
    p.add_argument("--weights", type=str, default=None,
                   help=".pth DRN checkpoint")
    p.add_argument("--superpixel_method", default="felzenszwalb",
                   choices=["felzenszwalb", "slic"])
    p.add_argument("--n_clusters", type=int, default=4)
    p.add_argument("--y_rel_pos", type=float, default=0.75)
    p.add_argument("--x_rel_pos", type=float, default=0.5)
    p.add_argument("--y_rel_sigma", type=float, default=0.1)
    p.add_argument("--x_rel_sigma", type=float, default=0.1)
    p.add_argument("--n_anchors", type=int, default=10)
    p.add_argument("--n_neighbors", type=int, default=4)
    p.add_argument("--without_pos", action="store_true", default=False)
    p.add_argument("--resize_shape", type=int, nargs=2, default=[224, 224])
    p.add_argument("--batchsize", type=int, default=30)
    p.add_argument("--felzenszwalb_scale", type=float, default=300.0)
    p.add_argument("--felzenszwalb_sigma", type=float, default=0.8)
    p.add_argument("--felzenszwalb_min_size", type=int, default=20)
    p.add_argument("--n_slic_segments", type=int, default=100)
    p.add_argument("--slic_no_connectivity", action="store_true",
                   default=False,
                   help="device SLIC without the connectivity pass (the "
                        "only SLIC frontend the port runs)")
    p.add_argument("--slic_device_downscale", type=int, default=1,
                   help="device-SLIC frontends only: compute the "
                        "superpixel map at 1/d scale")
    p.add_argument("--max_superpixels", type=int, default=1024)
    p.add_argument("--groups_per_dispatch", type=int, default=1,
                   help="independent clustering batches run together in "
                        "one unit (per-group results equal separate "
                        "units)")
    p.add_argument("--overlap_threshold", type=float, default=0.01)
    p.add_argument("--use_feature_maps", type=int, nargs="*", default=[7])
    p.add_argument("--out_dir", type=str, default="results/labels")
    p.add_argument("--start_index", type=int, default=0)
    p.add_argument("--end_index", type=int, default=None)
    p.add_argument("--seed", type=int, default=1111)
    p.add_argument("--kmeans_init", default="device",
                   choices=["device", "reference"],
                   help="'reference' is the bit-parity mode (not ported)")
    p.add_argument("--save_images", action="store_true", default=False)
    p.add_argument("--no_save_masks", action="store_true", default=False)
    p.add_argument("--model_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="feature-extractor compute dtype")
    p.add_argument("--upload_format", default="rgb8",
                   choices=["rgb8", "yuv420"],
                   help="image wire format (pipeline/wire.py): yuv420 "
                        "halves the bytes per image")
    p.add_argument("--resume", action="store_true", default=False,
                   help="skip images already present in out_dir's "
                        "result.json (crash restart)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without CUDA) or 'cpu'")
    add_dataset_args(p)
    return p.parse_args(argv)


def config_from_args(args) -> LabelGenConfig:
    return LabelGenConfig(
        mode=args.mode,
        resize_shape=tuple(args.resize_shape),
        batchsize=args.batchsize,
        use_feature_maps=tuple(args.use_feature_maps),
        prior=PriorConfig(args.y_rel_pos, args.x_rel_pos,
                          args.y_rel_sigma, args.x_rel_sigma),
        superpixel=SuperpixelConfig(
            method=args.superpixel_method,
            felzenszwalb_scale=args.felzenszwalb_scale,
            felzenszwalb_sigma=args.felzenszwalb_sigma,
            felzenszwalb_min_size=args.felzenszwalb_min_size,
            n_slic_segments=args.n_slic_segments,
            slic_enforce_connectivity=not args.slic_no_connectivity,
            slic_device_downscale=args.slic_device_downscale,
            max_superpixels=args.max_superpixels),
        align=AlignConfig(n_anchors=args.n_anchors,
                          n_neighbors=args.n_neighbors,
                          append_pos=not args.without_pos),
        kmeans=KMeansConfig(n_clusters=args.n_clusters, seed=args.seed,
                            init=args.kmeans_init),
        overlap_threshold=args.overlap_threshold,
        groups_per_dispatch=args.groups_per_dispatch,
        out_dir=args.out_dir,
        save_images=args.save_images,
        save_masks=not args.no_save_masks,
        model_dtype=args.model_dtype,
        upload_format=args.upload_format)


def main(argv=None):
    args = get_args(argv)
    cfg = config_from_args(args)
    dataset = build_label_dataset(args)
    state_dict = load_drn_weights(args)

    from spalign_tpu_torch.pipeline.direct import make_label_generator

    gen = make_label_generator(cfg, state_dict=state_dict,
                               model_name=args.model, seed=args.seed,
                               device=args.device)
    skip_done = None
    result_json = os.path.join(cfg.out_dir, "result.json")
    if args.resume and os.path.exists(result_json):
        skip_done = {r["img_fn"] for r in read_results(result_json)}
        print(f"[label_gen] resume: {len(skip_done)} images done")
    records = gen.process_dataset(dataset, start_index=args.start_index,
                                  end_index=args.end_index,
                                  skip_done=skip_done)
    scored = [r for r in records if "road_iou" in r]
    if scored:
        summary = write_summary(cfg.out_dir, read_results(result_json)
                                if not args.no_save_masks else scored)
        print(f"[label_gen] {cfg.mode}: n={summary['n']} "
              f"road IoU={summary['road_mean_iou']:.4f} "
              f"P={summary['precision']:.4f} R={summary['recall']:.4f}")
    else:
        print(f"[label_gen] {cfg.mode}: {len(records)} images, no GT")
    return records


if __name__ == "__main__":
    main()
