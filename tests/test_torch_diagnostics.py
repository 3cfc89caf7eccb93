"""The port's diagnostics against the JAX package's, on the CPU: the
device scorer (``pipeline/label_gen.score_full_res``) and
``data/labels.remap_label_ids``, the exact-permutation anchors of
``ops/segments.py``, ``utils/timers.profiler_trace`` behind the label
CLI's ``--profile_dir``, and the panels of ``utils/viz.py`` written by
``--save_images`` and relabel's ``save_panels``.

Tolerances: none.  The scorer equals JAX's ``score_full_res`` and the
host scorers bit for bit, the remap equals JAX's, the anchors equal
JAX's with JAX's permutation handed over.  The panels are held to their
own definition (the JAX package draws them with matplotlib, which the
port does not use): the layout and size, each mask cell equal to the
NN-resized mask under viridis, the overlay to the stated blend."""

import glob
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.data.labels import create_label_mask as jax_create_mask
from spalign_tpu.data.labels import remap_label_ids as jax_remap
from spalign_tpu.ops.segments import (
    sample_segment_anchors as jax_sample_anchors)
from spalign_tpu.pipeline.label_gen import score_full_res as jax_score
from spalign_tpu_torch.cli import label_gen as cli_label_gen
from spalign_tpu_torch.data.labels import remap_label_ids
from spalign_tpu_torch.data.png import decode_png
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.models.segnet import build_segnet
from spalign_tpu_torch.ops.resize import nn_resize_np
from spalign_tpu_torch.ops.segments import (exact_permutation,
                                            sample_segment_anchors)
from spalign_tpu_torch.pipeline.label_gen import (host_confusion,
                                                  host_confusion_reference,
                                                  score_full_res)
from spalign_tpu_torch.selftrain.relabel import relabel_dataset
from spalign_tpu_torch.utils import viz

torch.set_num_threads(2)


# --- the device scorer and the remap


@pytest.mark.parametrize("small,full", [((56, 56), (224, 448)),
                                        ((28, 56), (100, 200)),
                                        ((64, 128), (64, 128))])
def test_score_full_res_equals_jax_and_host(small, full):
    rng = np.random.RandomState(sum(small))
    road = rng.rand(3, *small) > 0.6
    labels = rng.randint(0, 34, (3, *full)).astype(np.uint8)
    labels[0, :4] = 255  # an id outside the table
    got = score_full_res(torch.from_numpy(road), torch.from_numpy(labels),
                         full).numpy()
    want = np.asarray(jax_score(jnp.asarray(road), jnp.asarray(labels),
                                full))
    assert got.shape == (3, 2, 2)
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        np.testing.assert_array_equal(got[b], host_confusion(road[b],
                                                             labels[b]))
        np.testing.assert_array_equal(
            got[b], host_confusion_reference(road[b], labels[b]))


def test_remap_label_ids_equals_jax():
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = remap_label_ids(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_remap(ids)))
    np.testing.assert_array_equal(got, jax_create_mask(ids))
    assert got.dtype == np.int32


# --- the exact-permutation anchors (num_segments > 65536)


def _segments(shape, n_seg, seed):
    """A (H, W) map of about n_seg random rectangles' ids."""
    rng = np.random.RandomState(seed)
    ys = np.sort(rng.choice(np.arange(1, shape[0]), 19, replace=False))
    xs = np.sort(rng.choice(np.arange(1, shape[1]), n_seg // 20 - 1,
                            replace=False))
    sp = (np.searchsorted(ys, np.arange(shape[0]), side="right")[:, None]
          * (len(xs) + 1)
          + np.searchsorted(xs, np.arange(shape[1]), side="right")[None])
    return sp.astype(np.int32)


@pytest.mark.parametrize("n_anchors", [4, 10])
def test_exact_permutation_anchors_equal_jax(n_anchors):
    s = 70000
    assert exact_permutation(s) and not exact_permutation(65536)
    sp = _segments((100, 120), 500, n_anchors)
    assert 400 <= sp.max() + 1 <= 500
    key = jax.random.key(n_anchors)
    yx_j, valid_j = jax_sample_anchors(jnp.asarray(sp), key, n_anchors, s)
    perm = np.asarray(jax.random.permutation(key, sp.size))
    yx, valid = sample_segment_anchors(torch.from_numpy(sp), n_anchors, s,
                                       random_bits=torch.from_numpy(perm))
    np.testing.assert_array_equal(yx.numpy(), np.asarray(yx_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))


def test_exact_permutation_own_draws_and_domain():
    s = 70000
    sp = torch.from_numpy(_segments((100, 120), 500, 3))
    gen = torch.Generator().manual_seed(0)
    yx, valid = sample_segment_anchors(sp, 10, s, generator=gen)
    ys, xs = yx[..., 0].long(), yx[..., 1].long()
    ids = torch.arange(s)[:, None].expand(s, 10)
    assert bool((sp[ys[valid], xs[valid]] == ids[valid]).all())
    flat = (ys * 120 + xs)[valid.any(1)]
    assert all(len(set(r[v].tolist())) == int(v.sum())
               for r, v in zip(flat, valid[valid.any(1)]))
    # JAX's domain: num_segments * n < 2**31
    big = torch.zeros((200, 200), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows int32"):
        sample_segment_anchors(big, 4, 70000, generator=gen)
    with pytest.raises(AssertionError):
        jax_sample_anchors(jnp.zeros((200, 200), jnp.int32),
                           jax.random.key(0), 4, 70000)


# --- --profile_dir


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    prof = tmp_path / "prof"
    cli_label_gen.main(["--mode", "direct", "--synthetic", "2",
                        "--synthetic_shape", "64", "128", "--batchsize",
                        "2", "--resize_shape", "56", "56", "--device",
                        "cpu", "--out_dir", str(tmp_path / "out"),
                        "--profile_dir", str(prof)])
    traces = glob.glob(str(prof / "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::conv2d" in names or "aten::convolution" in names


# --- panels


def test_diagnostic_panel_layout_and_colours():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (96, 160, 3)).astype(np.uint8)
    road = rng.rand(24, 40) > 0.5
    cluster = rng.randint(0, 4, (24, 40)).astype(np.uint8)
    label = rng.randint(-1, 2, (96, 160)).astype(np.int32)
    panel = viz.diagnostic_panel(img, road, cluster, label)
    hw = viz.cell_shape(img.shape[:2])
    assert hw == (96, 160)
    m, t = viz.MARGIN, viz.TITLE_BAND
    assert panel.shape == (2 * (t + 96) + 3 * m, 2 * 160 + 3 * m, 3)

    def cell(i):
        y, x = viz.cell_origin(i, 2, hw)
        return panel[y:y + hw[0], x:x + hw[1]]

    road_full = nn_resize_np(road.astype(np.uint8), img.shape[:2])
    cluster_full = nn_resize_np(cluster, img.shape[:2])
    blend = np.rint(0.6 * img.astype(np.float32) + 0.4 * np.where(
        road_full[..., None] == 1, viz.SET1_R_HIGH,
        viz.SET1_R_LOW).astype(np.float32)).astype(np.uint8)
    np.testing.assert_array_equal(cell(0), blend)
    np.testing.assert_array_equal(
        cell(1), np.where((label == 1)[..., None], viz.VIRIDIS[255],
                          viz.VIRIDIS[0]))
    lo, hi = cluster_full.min(), cluster_full.max()
    idx = np.minimum(((cluster_full - lo) / (hi - lo) * 256).astype(int),
                     255)
    np.testing.assert_array_equal(cell(2), viz.VIRIDIS[idx])
    np.testing.assert_array_equal(
        cell(3), np.where(road_full[..., None] == 1, viz.VIRIDIS[255],
                          viz.VIRIDIS[0]))
    # each title's band holds black text on white
    band = panel[m:m + t, m:m + hw[1]]
    assert (band == 0).any() and (band == 255).any()
    # a constant map takes viridis' first colour (imshow's vmin == vmax)
    np.testing.assert_array_equal(
        viz.colormap_viridis(np.ones((2, 2))), np.tile(viz.VIRIDIS[0],
                                                       (2, 2, 1)))


def test_prediction_panel_scales_down_and_leaves_missing_gt_white():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (512, 1280, 3)).astype(np.uint8)
    pred = rng.rand(64, 160) > 0.5
    panel = viz.prediction_panel(img, pred)
    hw = viz.cell_shape(img.shape[:2])
    assert hw == (205, 512)
    assert panel.shape == (viz.TITLE_BAND + 205 + 2 * viz.MARGIN,
                           3 * 512 + 4 * viz.MARGIN, 3)
    y, x = viz.cell_origin(1, 3, hw)
    assert (panel[y - viz.TITLE_BAND:y + hw[0], x:x + hw[1]] == 255).all()
    y, x = viz.cell_origin(2, 3, hw)
    np.testing.assert_array_equal(
        panel[y:y + hw[0], x:x + hw[1]],
        np.where(nn_resize_np(pred, hw)[..., None], viz.VIRIDIS[255],
                 viz.VIRIDIS[0]))


def test_save_images_writes_a_panel_per_scored_image(tmp_path):
    out = tmp_path / "labels"
    records = cli_label_gen.main([
        "--mode", "direct", "--synthetic", "3", "--synthetic_shape", "64",
        "128", "--batchsize", "3", "--resize_shape", "56", "56",
        "--device", "cpu", "--save_images", "--out_dir", str(out)])
    assert len(records) == 3
    for r in records:
        path = out / os.path.basename(r["img_fn"])
        img = decode_png(path.read_bytes())
        ch, cw = viz.cell_shape((64, 128))
        assert img.shape == (2 * (viz.TITLE_BAND + ch) + 3 * viz.MARGIN,
                             2 * cw + 3 * viz.MARGIN, 3)
        mask = np.load(out / (os.path.splitext(r["img_fn"])[0] + ".npy"))
        y, x = viz.cell_origin(3, 2, (ch, cw))
        np.testing.assert_array_equal(
            img[y:y + ch, x:x + cw],
            viz.colormap_viridis(nn_resize_np(mask, (ch, cw))))


class _RelabelView:
    def __init__(self, n, full=True):
        self.ds = SyntheticRoadScenes(n=n, full_shape=(32, 64), seed=5)
        if full:
            self.full_images = lambda idx: [self.ds[i][0] for i in idx]

    def __len__(self):
        return len(self.ds)

    def image_name(self, i):
        return self.ds.image_name(i)

    def __getitem__(self, i):
        img, lab = self.ds[i]
        return img.astype(np.float32) / 255.0, (lab == 7).astype(np.int32)


def test_relabel_save_panels(tmp_path):
    model = build_segnet("basic", 2, device="cpu")
    out_dir = tmp_path / "relabel"
    recs = relabel_dataset(model, None, _RelabelView(3),
                           str(tmp_path / "r.0.zip"), eval_shape=(32, 64),
                           batch_size=2, out_dir=str(out_dir),
                           save_panels=True, device="cpu")
    assert len(recs) == 3
    ch, cw = viz.cell_shape((32, 64))
    with np.load(tmp_path / "r.0.zip") as z:
        for r in recs:
            panel = decode_png((out_dir / r["img_fn"]).read_bytes())
            assert panel.shape == (viz.TITLE_BAND + ch + 2 * viz.MARGIN,
                                   3 * cw + 4 * viz.MARGIN, 3)
            pred = z[os.path.splitext(r["img_fn"])[0]]
            y, x = viz.cell_origin(2, 3, (ch, cw))
            np.testing.assert_array_equal(
                panel[y:y + ch, x:x + cw], viz.colormap_viridis(pred))
    # without full_images (or without out_dir) it warns and writes none
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        relabel_dataset(model, None, _RelabelView(2, full=False),
                        str(tmp_path / "s.0.zip"), eval_shape=(32, 64),
                        batch_size=2, out_dir=str(tmp_path / "s"),
                        save_panels=True, device="cpu")
    assert any("save_panels" in str(w.message) for w in caught)
    assert not glob.glob(str(tmp_path / "s" / "*.png"))
