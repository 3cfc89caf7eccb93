"""The port's host-side CLIs (spalign_tpu_torch/cli/make_zips.py,
bottom_half.py, mean_result.py, make_table.py with eval/tables.py, and
convert_model.py) against the JAX package's on the same inputs, on the
CPU.

Tolerances: zips, printed text, summary.txt and rounds.csv exact; the
converted DRN's output and eight maps within rtol 1e-3, atol 1e-4 of
the JAX package's conversion of the same .pth (its converter's bar)."""

import json
import os
import re
import zipfile

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.cli import bottom_half as jbottom_half
from spalign_tpu.cli import make_table as jmake_table
from spalign_tpu.cli import make_zips as jmake_zips
from spalign_tpu.cli import mean_result as jmean_result
from spalign_tpu.convert import load_drn_checkpoint
from spalign_tpu.convert.torch_drn import torch_drn_c_26
from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.cli import bottom_half, convert_model, make_table
from spalign_tpu_torch.cli import make_zips, mean_result
from spalign_tpu_torch.data.png import decode_png, write_png
from spalign_tpu_torch.eval import tables
from spalign_tpu_torch.models.drn import DRN_FACTORIES

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A fake Cityscapes val split (3 frames at 64x128) as files and as
    the two zips the JAX CLI makes of them."""
    root = tmp_path_factory.mktemp("tree")
    ds = SyntheticRoadScenes(n=3, full_shape=(64, 128), seed=5)
    for i in range(3):
        img, lab = ds[i]
        stem = f"town_000000_{i:06d}"
        os.makedirs(root / "img", exist_ok=True)
        os.makedirs(root / "lab", exist_ok=True)
        write_png(str(root / "img" / f"{stem}_leftImg8bit.png"), img)
        write_png(str(root / "lab" / f"{stem}_gtFine_labelIds.png"), lab)
    zips = {}
    for name in ("img", "lab"):
        zips[name] = str(root / f"{name}.zip")
        jmake_zips.main(["dir", str(root / name / "*.png"), zips[name]])
    return root, zips


@pytest.mark.parametrize("cmd", ["dir", "filelist"])
def test_make_zips_equal_jax(tree, tmp_path, capsys, cmd):
    root, _ = tree
    if cmd == "dir":
        src = str(root / "img" / "*.png")
    else:
        src = str(tmp_path / "list.txt")
        with open(src, "w") as f:
            f.write("\n".join(sorted(str(p) for p in (root / "img").iterdir()))
                    + "\n")
    mine, theirs = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
    make_zips.main([cmd, src, mine])
    said = capsys.readouterr().out
    jmake_zips.main([cmd, src, theirs])
    assert said.replace("port.zip", "jax.zip") == capsys.readouterr().out
    with zipfile.ZipFile(mine) as a, zipfile.ZipFile(theirs) as b:
        assert a.namelist() == b.namelist() and len(a.namelist()) == 3
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in a.infolist())
        for name in a.namelist():
            assert a.read(name) == b.read(name)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_make_zips_synthetic_decodes_to_jax_pixels(tmp_path):
    args = ["synthetic", "--n", "2", "--shape", "48", "96", "--seed", "3"]
    make_zips.main(args + ["--out_prefix", str(tmp_path / "port")])
    jmake_zips.main(args + ["--out_prefix", str(tmp_path / "jax")])
    for kind, color in (("imgs", True), ("labels", False)):
        with zipfile.ZipFile(tmp_path / f"port_{kind}.0.zip") as a, \
                zipfile.ZipFile(tmp_path / f"jax_{kind}.0.zip") as b:
            assert a.namelist() == b.namelist()
            for name in a.namelist():
                flag = cv2.IMREAD_COLOR if color else cv2.IMREAD_UNCHANGED
                want = cv2.imdecode(np.frombuffer(b.read(name), np.uint8),
                                    flag)
                got_cv2 = cv2.imdecode(np.frombuffer(a.read(name), np.uint8),
                                       flag)
                got = decode_png(a.read(name), color=color)
                if color:
                    want, got_cv2 = want[..., ::-1], got_cv2[..., ::-1]
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got_cv2, want)


def test_bottom_half_prints_jax_text(tree, capsys):
    _, zips = tree
    args = ["--cityscapes_img_zip", zips["img"], "--cityscapes_label_zip",
            zips["lab"]]
    bottom_half.main(args + ["--device", "cpu"])
    mine = capsys.readouterr().out
    jbottom_half.main(args)
    assert mine == capsys.readouterr().out
    assert mine.startswith("bottom-half baseline over 3 images:")


def test_mean_result_equals_jax(tmp_path, capsys):
    rng = np.random.RandomState(0)
    recs = []
    for i in range(6):
        tp, fp, fn = (int(v) for v in rng.randint(0, 5000, 3))
        recs.append({"img_fn": f"img_{i % 5}.png",
                     "road_iou": tp / (tp + fp + fn), "non_road_iou":
                     float(rng.rand()), "precision": tp / (tp + fp),
                     "recall": None if i == 2 else tp / (tp + fn),
                     "TP": tp, "FP": fp, "FN": fn})
    recs[3]["road_iou"] = 0.0
    out = {}
    for name, fn in (("port", mean_result.main), ("jax", jmean_result.main)):
        d = tmp_path / name
        d.mkdir()
        with open(d / "result.json", "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
        fn([str(d / "result.json"), "--show_failed_fn"])
        with open(d / "summary.txt") as f:
            out[name] = (capsys.readouterr().out.replace(str(d), "D"),
                         f.read())
    assert out["port"] == out["jax"]
    assert "img_3.png" in out["port"][0]


def _round_logs(base):
    rng = np.random.RandomState(1)
    for n in (1, 2, 3):
        d = base / f"train_round{n}"
        d.mkdir(parents=True)
        entries = [{"iteration": 10 * k, "main/loss": float(rng.rand())}
                   for k in range(3)]
        entries += [{"val/main/iou/road": float(rng.rand()),
                     "val/main/precision": float(rng.rand()),
                     "val/main/recall": float(rng.rand())}
                    for _ in range(3)]
        with open(d / "log", "w") as f:
            json.dump(entries, f)
    (base / "unrelated").mkdir()


def test_make_table_csv_equals_jax(tmp_path, capsys):
    _round_logs(tmp_path / "port")
    _round_logs(tmp_path / "jax")
    make_table.main([str(tmp_path / "port")])
    mine = capsys.readouterr().out
    jmake_table.main([str(tmp_path / "jax")])
    assert mine.replace("port", "jax") == capsys.readouterr().out
    with open(tmp_path / "port" / "rounds.csv", "rb") as f, \
            open(tmp_path / "jax" / "rounds.csv", "rb") as g:
        assert f.read() == g.read()


def test_make_table_pdf(tmp_path):
    _round_logs(tmp_path)
    _, pdf = make_table.main([str(tmp_path), "--plot"])
    assert pdf == str(tmp_path / "rounds_iou.pdf")
    with open(pdf, "rb") as f:
        data = f.read()
    assert data.startswith(b"%PDF-1.4\n") and data.endswith(b"%%EOF\n")
    startxref = int(re.search(rb"startxref\n(\d+)\n%%EOF", data).group(1))
    assert data[startxref:].startswith(b"xref\n0 6\n")
    entries = re.findall(rb"(\d{10}) (\d{5}) ([nf]) \n",
                         data[startxref:])
    assert len(entries) == 6 and entries[0][2] == b"f"
    for num, (off, _, _) in enumerate(entries[1:], 1):
        assert data[int(off):].startswith(b"%d 0 obj\n" % num)
    assert b"/BaseFont /Helvetica" in data
    stream = re.search(rb"stream\n(.*)\nendstream", data, re.S).group(1)
    length = int(re.search(rb"/Length (\d+)", data).group(1))
    assert length == len(stream)
    assert b"(self-training round) Tj" in stream
    assert b"(val/main/iou/road) Tj" in stream
    # the polyline: an affine image of (round, best IoU) of each round
    best = tables.best_metric_per_round(tables.load_round_logs(
        str(tmp_path)))
    # the first path stroked in the data colour
    line = re.search(rb"0\.71 rg\n([0-9. ]+ m(?: [0-9. ]+ l)+) S\n", stream)
    pts = np.array([float(v) for v in re.findall(rb"[0-9.]+",
                                                 line.group(1))]).reshape(
        -1, 2)
    xs, ys = sorted(best), np.array([best[k] for k in sorted(best)])
    assert len(pts) == len(xs) == 3
    np.testing.assert_allclose(np.diff(pts[:, 0]), np.diff(pts[:2, 0])[0],
                               atol=2e-3)
    scale = (pts[1, 1] - pts[0, 1]) / (ys[1] - ys[0])
    np.testing.assert_allclose(pts[:, 1] - pts[0, 1], scale * (ys - ys[0]),
                               atol=2e-3)
    assert scale > 0
    # a marker (a closed four-arc circle) at each point
    assert stream.count(b" c f") == 3


@pytest.fixture(scope="module")
def donor_pth(tmp_path_factory):
    """A .pth from the JAX package's torch donor DRN-C-26 with seeded
    weights and non-trivial BN statistics."""
    torch.manual_seed(3)
    donor = torch_drn_c_26()
    with torch.no_grad():
        for m in donor.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = str(tmp_path_factory.mktemp("pth") / "drn.pth")
    torch.save(donor.state_dict(), path)
    return path


def test_convert_model_equals_jax_conversion(donor_pth, tmp_path, capsys):
    out = str(tmp_path / "drn_port.pth")
    worst = convert_model.main([donor_pth, out, "--check", "--device",
                                "cpu"])
    assert worst == 0.0  # the CPU against itself
    said = capsys.readouterr().out
    assert said.startswith(f"converted {donor_pth} -> {out}\n")
    assert "parity check passed" in said
    state = torch.load(out, weights_only=True)
    port = DRN_FACTORIES["drn_c_26"](device="cpu")
    port.load_state_dict(state, strict=True)
    assert all(v.dtype == torch.float32 for v in state.values()
               if v.is_floating_point())
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    model, variables = load_drn_checkpoint(donor_pth, "drn_c_26")
    jout, jmaps = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        tout, tmaps = port(torch.from_numpy(x))
    assert len(tmaps) == len(jmaps) == 8
    for t, j in zip((tout, *tmaps), (jout, *jmaps)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("fault", ["dropped", "shape"])
def test_convert_model_names_the_key(donor_pth, tmp_path, fault):
    state = torch.load(donor_pth, weights_only=True)
    key = "layer3.0.conv1.weight"
    if fault == "dropped":
        del state[key]
    else:
        state[key] = torch.zeros(3, 3, 3, 3)
    bad = str(tmp_path / "bad.pth")
    torch.save(state, bad)
    with pytest.raises(ValueError, match=re.escape(key)):
        convert_model.main([bad, str(tmp_path / "out.pth")])
    assert not os.path.exists(tmp_path / "out.pth")
