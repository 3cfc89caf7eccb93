"""One further rank of a data-parallel training cell, started by rank 0
(the harness's process, ``drivers/train.py``): it joins the process
group, sets up its trainer and loader on its own card, runs the checked
steps and the window's steps in step with rank 0, and exits.  It prints
no result.

    python3 perfbench/rank.py --spec <json> --seed <n> --rank <r> \
        --port <p> --device cuda|cpu [--hook module:function]
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spec", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--hook")
    args = p.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch

    from perfbench.drivers.train import Cell

    with open(args.spec) as f:
        spec = json.load(f)
    if args.hook:
        mod, fn = args.hook.split(":")
        getattr(importlib.import_module(mod), fn)()
    cell = Cell(spec["config"], spec["traffic"], args.seed,
                torch.device(args.device), chips=spec["chips"],
                rank=args.rank)
    cell.join(args.port)
    cell.setup()
    cell.window(float("inf"), False)
    cell._free_program()
    return 0


if __name__ == "__main__":
    sys.exit(main())
