"""Ablation sweep CLI (replaces the utils/dmux/* cluster scripts).

Counterpart of ``spalign_tpu/cli/sweep.py``: the paper's ablation grids
in one process, one configuration after another:
  fig7: k in {2..8}            (utils/dmux/run_exp_fig-7.sh)
  fig8: clustering batch 1..50 (run_exp_fig-8.sh)
  fig9: felzenszwalb scale 100..800 (run_exp_fig-9.sh)
Custom single-axis sweeps: --param kmeans.n_clusters --values 2 3 4.
The other flags are the label CLI's (``cli/label_gen.py``), ``--device``
included.

Writes one CSV row per configuration with the aggregate metrics, in the
JAX package's columns.  One generator runs the whole grid: each value is
a ``reconfigure`` of it, so the rows consume one host seed stream in
order, as JAX's do.  Its ``program_traces`` column (JAX's count of
compiled programs) holds -1: torch traces nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from spalign_tpu_torch.cli.common import build_label_dataset, load_drn_weights
from spalign_tpu_torch.cli.label_gen import config_from_args, get_args as \
    label_gen_args
from spalign_tpu_torch.eval.results import aggregate_results
from spalign_tpu_torch.pipeline.direct import make_label_generator

FIG_GRIDS = {
    "fig7": ("kmeans.n_clusters", [2, 3, 4, 5, 6, 7, 8]),
    "fig8": ("batchsize", [1, 5, 10, 20, 30, 40, 50]),
    "fig9": ("superpixel.felzenszwalb_scale",
             [100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0]),
}


def set_nested(cfg, dotted: str, value):
    parts = dotted.split(".")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    sub = getattr(cfg, parts[0])
    return dataclasses.replace(
        cfg, **{parts[0]: set_nested(sub, ".".join(parts[1:]), value)})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, add_help=False)
    p.add_argument("--grid", choices=list(FIG_GRIDS) + ["custom"],
                   default="fig7")
    p.add_argument("--param", type=str, default=None,
                   help="dotted config path for --grid custom")
    p.add_argument("--values", type=float, nargs="*", default=None)
    p.add_argument("--sweep_out", type=str, default="results/sweep.csv")
    sweep_args, rest = p.parse_known_args(argv)

    base_args = label_gen_args(rest)
    base_cfg = config_from_args(base_args)
    dataset = build_label_dataset(base_args, base_cfg.resize_shape)
    state_dict = load_drn_weights(base_args)

    if sweep_args.grid == "custom":
        if not sweep_args.param or sweep_args.values is None:
            raise SystemExit("--grid custom needs --param and --values")
        param, values = sweep_args.param, sweep_args.values
    else:
        param, values = FIG_GRIDS[sweep_args.grid]

    os.makedirs(os.path.dirname(sweep_args.sweep_out) or ".",
                exist_ok=True)
    dynamic_k = None
    if param == "kmeans.n_clusters":
        if min(values) < 2:
            # the seeding labels rank % (k - 1) + 1: k < 2 has no labels
            raise SystemExit("kmeans.n_clusters sweep values must be >= 2")
        dynamic_k = int(max(values))
    gen = make_label_generator(base_cfg, state_dict=state_dict,
                               model_name=base_args.model,
                               seed=base_args.seed, device=base_args.device,
                               dynamic_k=dynamic_k)
    rows = []
    for v in values:
        if param in ("kmeans.n_clusters", "batchsize"):
            v = int(v)
        cfg = set_nested(base_cfg, param, v)
        cfg = dataclasses.replace(
            cfg, out_dir=os.path.join(base_cfg.out_dir, f"{param}={v}"))
        gen.reconfigure(cfg)
        t0 = time.time()
        records = gen.process_dataset(dataset, save=False)
        seconds = time.time() - t0
        agg = aggregate_results([r for r in records if "road_iou" in r])
        traces = gen.n_program_traces()
        rows.append((v, agg, traces, seconds))
        print(f"{param}={v}: road IoU={agg['road_mean_iou']:.4f} "
              f"P={agg['precision']:.4f} R={agg['recall']:.4f} "
              f"(program traces so far: {traces})")

    with open(sweep_args.sweep_out, "w") as f:
        f.write(f"{param},road_mean_iou,precision,recall,n,"
                f"program_traces\n")
        for v, agg, traces, _ in rows:
            f.write(f"{v},{agg['road_mean_iou']},{agg['precision']},"
                    f"{agg['recall']},{agg['n']},{traces}\n")
    print(f"wrote {sweep_args.sweep_out} "
          f"(fused program traced {rows[-1][2]}x for {len(values)} "
          f"configurations)")
    return rows  # (value, aggregate, program traces, seconds) a row


if __name__ == "__main__":
    main()
