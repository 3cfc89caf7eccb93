"""result.json aggregation CLI (replaces utils/mean_result.py): prints
and writes summary.txt with mean/min/max IoU + micro-averaged
precision/recall (the README headline numbers).

Counterpart of ``spalign_tpu/cli/mean_result.py`` with the same flags,
output and ``summary.txt``; host-only, so no ``--device``.
"""

from __future__ import annotations

import argparse
import os

from spalign_tpu_torch.eval.results import (aggregate_results,
                                            format_summary, read_results)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("result_json", type=str)
    p.add_argument("--show_failed_fn", action="store_true", default=False)
    p.add_argument("--count_duplicated", action="store_true",
                   default=False)
    p.add_argument("--n_imgs", type=int, default=None)
    args = p.parse_args(argv)

    records = read_results(args.result_json,
                           dedup=not args.count_duplicated,
                           n_imgs=args.n_imgs)
    if args.show_failed_fn:
        for r in records:
            if r.get("road_iou") == 0:
                print(r["img_fn"])
    summary = aggregate_results(records)
    msg = format_summary(summary)
    print(args.result_json)
    print(msg)
    with open(os.path.join(os.path.dirname(args.result_json) or ".",
                           "summary.txt"), "w") as fp:
        fp.write(msg)
    return summary


if __name__ == "__main__":
    main()
