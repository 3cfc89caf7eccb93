"""Cross-round tables/plots CLI (replaces utils/make_table.py).

Counterpart of ``spalign_tpu/cli/make_table.py`` with the same flags and
output; ``--plot`` writes ``rounds_iou.pdf`` with the port's own PDF
writer (``eval/tables.py``).  Host-only, so no ``--device``.
"""

from __future__ import annotations

import argparse

from spalign_tpu_torch.eval.tables import plot_rounds, write_rounds_csv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("result_base_dir", type=str)
    p.add_argument("--out_csv", type=str, default=None)
    p.add_argument("--plot", action="store_true", default=False)
    args = p.parse_args(argv)

    csv = write_rounds_csv(args.result_base_dir, args.out_csv)
    print(f"wrote {csv}")
    with open(csv) as f:
        print(f.read())
    pdf = None
    if args.plot:
        pdf = plot_rounds(args.result_base_dir)
        if pdf:
            print(f"wrote {pdf}")
    return csv, pdf


if __name__ == "__main__":
    main()
