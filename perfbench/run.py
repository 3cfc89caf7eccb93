"""Run one cell of the benchmark once, on the card this process sees.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found by
name from ``BENCHMARK.json`` (``perfbench/harness.py``).  The last line of
standard output is the result: one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``busy_s`` and
``window_s`` too when traced), ``breakdown`` when traced, and last
``checks``, each compared number beside its limit; the same numbers are
the last lines of standard error.  Without CUDA, or with fewer cards than
the cell asks for, it exits 3 and prints no result.

Build and kernel caches stay inside the checkout: the program builds into
``spalign_tpu_torch/_build/``, and ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` point under ``.perfbench_cache/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = REPO / ".perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))

    import torch

    from perfbench import harness

    bench = harness.benchmark()
    spec = harness.cell_spec(bench, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s), this "
              f"process sees {n}; no result", file=sys.stderr)
        return 3
    harness.log(f"card: {harness.power_limit()}")
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), bench=bench, spec=spec)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"perfbench: forbidden modules loaded: {leaked}; no result",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
