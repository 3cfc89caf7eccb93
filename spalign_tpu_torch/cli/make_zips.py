"""Dataset packaging CLI (replaces utils/create_zip_files.sh): build
store-only zips for zip-backed random access, or emit a synthetic
dataset for data-free pipelines.

Counterpart of ``spalign_tpu/cli/make_zips.py`` with the same
subcommands, member names and bytes; the synthetic set's PNGs come from
the port's encoder (``data/png.py``) where JAX uses cv2's.  Host-only,
so no ``--device``.
"""

from __future__ import annotations

import argparse
import glob
import os
import zipfile


def zip_paths(paths, out_zip, arc_prefix=""):
    os.makedirs(os.path.dirname(out_zip) or ".", exist_ok=True)
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_STORED) as zf:
        for p in paths:
            zf.write(p, os.path.join(arc_prefix, os.path.basename(p)))
    return len(paths)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dir", help="zip files matching a glob")
    d.add_argument("pattern", type=str)
    d.add_argument("out_zip", type=str)

    fl = sub.add_parser("filelist", help="zip files from a list .txt")
    fl.add_argument("list_fn", type=str)
    fl.add_argument("out_zip", type=str)

    syn = sub.add_parser("synthetic",
                         help="generate a synthetic cityscapes-like "
                              "dataset as img/label zips")
    syn.add_argument("--n", type=int, default=30)
    syn.add_argument("--shape", type=int, nargs=2, default=[1024, 2048])
    syn.add_argument("--seed", type=int, default=0)
    syn.add_argument("--out_prefix", type=str, default="data/synthetic")

    args = p.parse_args(argv)

    if args.cmd == "dir":
        n = zip_paths(sorted(glob.glob(args.pattern)), args.out_zip)
        print(f"zipped {n} files into {args.out_zip}")
    elif args.cmd == "filelist":
        with open(args.list_fn) as f:
            paths = [line.strip() for line in f if line.strip()]
        n = zip_paths(paths, args.out_zip)
        print(f"zipped {n} files into {args.out_zip}")
    elif args.cmd == "synthetic":
        from spalign_tpu_torch.data.png import encode_png
        from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes

        ds = SyntheticRoadScenes(n=args.n, full_shape=tuple(args.shape),
                                 seed=args.seed)
        img_zip = args.out_prefix + "_imgs.0.zip"
        lab_zip = args.out_prefix + "_labels.0.zip"
        os.makedirs(os.path.dirname(img_zip) or ".", exist_ok=True)
        with zipfile.ZipFile(img_zip, "w") as zi, \
                zipfile.ZipFile(lab_zip, "w") as zl:
            for i in range(args.n):
                img, lab = ds[i]
                zi.writestr(ds.image_name(i), encode_png(img))
                zl.writestr(ds.label_name(i), encode_png(lab))
        print(f"wrote {img_zip} + {lab_zip} ({args.n} scenes)")


if __name__ == "__main__":
    main()
