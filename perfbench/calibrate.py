"""The readings the limits of ``correct`` are set from: for each seed, a
short run of the cell at its own sizes with the check's numbers (the
program against the reference) and the controls' (the reference in the
next lower precision, and for training the planted faults, against the
reference).  One process runs every seed; one JSON line a seed.

    python3 perfbench/calibrate.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

The benchmark's own runs never compute the controls.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               readings=True)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "failed": out["failed"],
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()},
                          "readings": out["readings"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
