"""The port's training curves (spalign_tpu_torch/utils/curves.py, drawn by
``Trainer.fit`` at each evaluation point) against the JAX package's
``Trainer._plots``: the same four file names from the same log keys,
none for a figure whose series are all empty, and only on rank 0.  The
drawing is the port's own (numpy, not matplotlib), so its pixels are
checked against its stated data-to-pixel map: each series' colour lies
at the pixel each of its values maps to."""

import os

import numpy as np
import pytest
import torch

from spalign_tpu.config import TrainConfig as JaxTrainConfig
from spalign_tpu.parallel import make_mesh
from spalign_tpu.train.evaluator import Evaluator as JaxEvaluator
from spalign_tpu.train.trainer import Trainer as JaxTrainer
from spalign_tpu_torch.config import TrainConfig
from spalign_tpu_torch.data.png import decode_png
from spalign_tpu_torch.train.evaluator import Evaluator
from spalign_tpu_torch.train.trainer import Trainer
from spalign_tpu_torch.utils.curves import (COLORS, CURVES, HEIGHT, WIDTH,
                                            draw_curves, frame, series,
                                            to_pixel, write_curves)

torch.set_num_threads(2)
HW = (32, 64)
KW = dict(model="basic", batchsize=2, input_shape=HW, eval_shape=HW,
          train_iters=4, log_interval=1, val_interval=2, optimizer="Adam",
          loss="ce")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    labels = np.zeros((2, *HW), np.int32)
    labels[:, :, HW[1] // 2:] = 1
    imgs = np.where(labels[..., None] == 1, 1.0, -1.0).astype(np.float32)
    return imgs + rng.randn(2, *HW, 3).astype(np.float32) * 0.1, labels


def _forever(batch):
    while True:
        yield batch


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def _read(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """(the port's result dir and log, the JAX trainer's result dir)."""
    tmp = tmp_path_factory.mktemp("curves")
    batch = _data()
    jdir = tmp / "jax"
    jtr = JaxTrainer(JaxTrainConfig(**KW, result_dir=str(jdir)),
                     mesh=make_mesh(1))
    jtr.fit(_forever(batch), evaluator=JaxEvaluator(
        jtr.model, lambda: iter([batch]), HW))
    tdir = tmp / "port"
    tr = Trainer(TrainConfig(**KW, result_dir=str(tdir)), device="cpu")
    tr.fit(_forever(batch), evaluator=Evaluator(
        tr.model, lambda: iter([batch]), HW, device="cpu"))
    return tdir, tr._log, jdir


def test_fit_writes_jax_files(fits):
    tdir, _, jdir = fits
    assert _pngs(tdir) == _pngs(jdir) == sorted(CURVES)
    for fn in CURVES:
        img = _read(tdir / fn)
        assert img.shape == (HEIGHT, WIDTH, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("fn", sorted(CURVES))
def test_fit_series_at_their_pixels(fits, fn):
    """The figure's last series (drawn over the others) has its colour
    at every value's pixel; every series' colour is in the figure."""
    tdir, log, _ = fits
    data = [(k, *series(log, k)) for k in CURVES[fn]]
    assert all(xs for _, xs, _ in data)
    img = _read(tdir / fn)
    fr = frame(data)
    for i, (_, xs, ys) in enumerate(data):
        assert (img == COLORS[i]).all(-1).any()
    _, xs, ys = data[-1]
    for x, y in zip(xs, ys):
        r, c = to_pixel(fr, x, y)
        assert tuple(img[r, c]) == tuple(COLORS[len(data) - 1])


def test_series_values_map_to_their_pixels():
    data = [("main/loss", [1, 2, 3, 4, 5], [0.9, 0.8, 0.7, 0.65, 0.6]),
            ("val/main/loss", [2, 4], [0.1, 0.15])]
    img = draw_curves(data)
    fr = frame(data)
    assert fr.left < fr.right and fr.top < fr.bottom
    for i, (_, xs, ys) in enumerate(data):
        for x, y in zip(xs, ys):
            r, c = to_pixel(fr, x, y)
            assert fr.top < r < fr.bottom and fr.left < c < fr.right
            assert tuple(img[r, c]) == tuple(COLORS[i])
    # the extreme values keep off the box's edges
    assert to_pixel(fr, 1, 0.9)[0] > fr.top + 2
    assert to_pixel(fr, 5, 0.1)[1] < fr.right - 2


def test_empty_series_give_no_file(tmp_path):
    log = [{"iteration": 1, "main/loss": 0.5},
           {"iteration": 2, "main/loss": 0.4, "val/main/iou/road": None,
            "val/main/precision": float("nan")}]
    paths = write_curves(log, str(tmp_path))
    assert paths == [str(tmp_path / "loss.png")]
    assert _pngs(tmp_path) == ["loss.png"]
    with pytest.raises(ValueError):
        draw_curves([("main/loss", [], [])])


def test_no_evaluator_and_other_ranks_write_none(tmp_path):
    batch = _data(1)
    tr = Trainer(TrainConfig(**dict(KW, train_iters=2),
                             result_dir=str(tmp_path / "plain")),
                 device="cpu")
    tr.fit(_forever(batch))  # no evaluator: no curves, as in JAX
    assert _pngs(tmp_path / "plain") == []
    tr = Trainer(TrainConfig(**dict(KW, train_iters=2),
                             result_dir=str(tmp_path / "rank1")),
                 device="cpu")
    tr.rank = 1  # as a rank other than 0 of a process group
    tr.fit(_forever(batch), evaluator=Evaluator(
        tr.model, lambda: iter([batch]), HW, device="cpu"))
    assert _pngs(tmp_path / "rank1") == []
