"""The port's training path (spalign_tpu_torch/train/, data/loader.py,
data/estimated.py) against the JAX package's, on the CPU.

Tolerances: losses rtol 1e-5 (float32, another summation order); one
MomentumSGD step: loss and gradient norm rtol 1e-5, every parameter and
running statistic rtol 1e-4 / atol 1e-5 (the bar of
tests/test_train.py's data-parallel test); Adam: losses of 3 steps rtol
1e-3 only (see the test); evaluator: confusion counts within 0.1% of
the pixels, loss rtol 1e-4."""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spalign_tpu.config import TrainConfig as JaxTrainConfig
from spalign_tpu.data.estimated import _NpyZipStore as JaxNpyZipStore
from spalign_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader
from spalign_tpu.parallel import make_mesh
from spalign_tpu.train import Trainer as JaxTrainer
from spalign_tpu.train import create_train_state, make_train_step
from spalign_tpu.train import losses as jlosses
from spalign_tpu.train.evaluator import Evaluator as JaxEvaluator
from spalign_tpu_torch.config import TrainConfig
from spalign_tpu_torch.convert.from_jax import segnet_state_dict_from_flax
from spalign_tpu_torch.data.estimated import (CITYSCAPES_MEAN,
                                              CITYSCAPES_STD,
                                              EstimatedCityscapesDataset,
                                              _NpyZipStore)
from spalign_tpu_torch.data.loader import PrefetchLoader
from spalign_tpu_torch.data.synthetic import (SyntheticRoadScenes,
                                              resize_bicubic_f32)
from spalign_tpu_torch.train import losses as tlosses
from spalign_tpu_torch.train.checkpoints import (SnapshotCallback,
                                                 find_snapshot,
                                                 load_predictor,
                                                 load_snapshot)
from spalign_tpu_torch.train.evaluator import Evaluator
from spalign_tpu_torch.train.trainer import Trainer, lr_at, make_optimizer

torch.set_num_threads(2)
HW = (32, 64)


def tiny(**kw):
    base = dict(model="basic", batchsize=2, input_shape=HW, eval_shape=HW,
                train_iters=8, log_interval=4, val_interval=8,
                optimizer="Adam", loss="ce")
    base.update(kw)
    return base


def synthetic_batch(rng, n, h, w):
    """Images whose left half is class 0 and right half class 1 — a
    trivially learnable task (tests/test_train.py's)."""
    labels = np.zeros((n, h, w), np.int32)
    labels[:, :, w // 2:] = 1
    imgs = np.where(labels[..., None] == 1, 1.0, -1.0).astype(np.float32)
    imgs = imgs + rng.randn(n, h, w, 3).astype(np.float32) * 0.1
    return imgs, labels


def _carried_trainer(jcfg_kw, tmp_path, seed=0):
    """A JAX train state and a CPU Trainer holding the same weights."""
    jcfg = JaxTrainConfig(**jcfg_kw, seed=seed)
    state = create_train_state(jcfg, sample_batch_shape=HW)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    tr = Trainer(TrainConfig(**jcfg_kw, seed=seed,
                             result_dir=str(tmp_path)), device="cpu")
    tr.model.load_state_dict(segnet_state_dict_from_flax(variables, "basic"))
    return jcfg, state, tr


# ---- losses ----

def _loss_inputs(name, rng):
    logits = rng.randn(2, 4, 4, 3).astype(np.float32)
    if name == "ce":
        return logits, rng.randint(-1, 3, size=(2, 4, 4)).astype(np.int32)
    if name == "ce_all_void":
        return logits, -np.ones((2, 4, 4), np.int32)
    t = rng.rand(2, 4, 4, 3).astype(np.float32)
    return logits, (t / t.sum(-1, keepdims=True) if name == "soft" else t)


@pytest.mark.parametrize("name", ["ce", "ce_all_void", "soft", "mse"])
def test_losses_match_jax(name):
    logits, target = _loss_inputs(name, np.random.RandomState(0))
    key = "ce" if name.startswith("ce") else name
    want = float(jlosses.get_loss_fn(key)(jnp.asarray(logits),
                                          jnp.asarray(target)))
    got = float(tlosses.get_loss_fn(key)(torch.from_numpy(logits),
                                         torch.from_numpy(target)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# ---- train steps against make_train_step ----

def test_momentum_sgd_step_matches_jax(tmp_path):
    kw = tiny(optimizer="MomentumSGD", lr=0.1, weight_decay=5e-4)
    jcfg, state, tr = _carried_trainer(kw, tmp_path)
    imgs, labels = synthetic_batch(np.random.RandomState(1), 2, *HW)
    new, m = make_train_step(jcfg)(state, jnp.asarray(imgs),
                                   jnp.asarray(labels))
    got = tr.train_step(*tr.to_device(imgs, labels))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(m["grad_norm"]), rtol=1e-5)
    want = segnet_state_dict_from_flax(jax.device_get(
        {"params": new.params, "batch_stats": new.batch_stats}), "basic")
    sd = tr.model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_adam_losses_match_jax(tmp_path):
    """Adam's first update is +-lr wherever a gradient is non-zero, so a
    gradient of 1e-9 that rounds the other way flips its parameter's
    step: parameters are not compared element by element, the losses of
    three steps are."""
    jcfg, state, tr = _carried_trainer(tiny(), tmp_path)
    step = make_train_step(jcfg)
    imgs, labels = synthetic_batch(np.random.RandomState(2), 2, *HW)
    want, got = [], []
    for _ in range(3):
        state, m = step(state, jnp.asarray(imgs), jnp.asarray(labels))
        want.append(float(m["loss"]))
        got.append(float(tr.train_step(*tr.to_device(imgs,
                                                      labels))["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_lr_staircase_matches_optax():
    """MomentumSGD with coupled weight decay and x0.1 every
    decay_iteration updates: the parameter trajectory of optax's chain
    (add_decayed_weights, sgd with a staircase schedule) on the loss
    sum(p), whose gradient is 1, around the decay steps."""
    cfg = TrainConfig(optimizer="MomentumSGD", lr=0.1, decay_iteration=3,
                      weight_decay=5e-4)
    sched = optax.exponential_decay(0.1, 3, 0.1, staircase=True)
    tx = optax.chain(optax.add_decayed_weights(5e-4),
                     optax.sgd(sched, momentum=0.9))
    p_j = jnp.ones((2,), jnp.float32)
    opt_state = tx.init(p_j)
    p_t = torch.nn.Parameter(torch.ones(2))
    opt, lr_sched = make_optimizer(cfg, [p_t])
    for k in range(8):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(sched(k)), rel=1e-6)
        assert lr_at(cfg, k) == pytest.approx(float(sched(k)), rel=1e-6)
        upd, opt_state = tx.update(jnp.ones((2,)), opt_state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        p_t.grad = torch.ones(2)
        opt.step()
        lr_sched.step()
        np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j),
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype,factor", [("float32", 0.8),
                                          ("bfloat16", 0.9)])
def test_loss_decreases(dtype, factor, tmp_path):
    """12 steps on the learnable synthetic task (the bars of
    tests/test_train.py); bfloat16 keeps float32 parameters."""
    tr = Trainer(TrainConfig(**tiny(batchsize=8, compute_dtype=dtype),
                             result_dir=str(tmp_path)), device="cpu")
    assert tr.model.conv1.weight.dtype == torch.float32
    imgs, labels = synthetic_batch(np.random.RandomState(3), 8, *HW)
    batch = tr.to_device(imgs, labels)
    losses = [float(tr.train_step(*batch)["loss"]) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * factor, losses


def test_one_card_only(tmp_path):
    """Without a process group of 2 ranks, num_devices=2 raises and names
    the launcher (data parallelism: tests/test_torch_ddp.py)."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        Trainer(TrainConfig(num_devices=2, result_dir=str(tmp_path)),
                device="cpu")


# ---- the loop, evaluation, snapshots ----

def _val(rng):
    imgs, labels = synthetic_batch(rng, 2, *HW)
    labels = np.repeat(np.repeat(labels, 2, 1), 2, 2)  # eval at 2x
    labels[:, :3] = -1  # a void band
    return imgs, labels


def test_fit_evaluator_snapshots_and_resume(tmp_path):
    kw = tiny(train_iters=4, val_interval=2, log_interval=2,
              eval_shape=(64, 128))
    rng = np.random.RandomState(4)
    imgs, labels = synthetic_batch(rng, 2, *HW)
    val = _val(rng)

    def forever():
        while True:
            yield imgs, labels

    jdir = tmp_path / "jax"
    jtr = JaxTrainer(JaxTrainConfig(**kw, result_dir=str(jdir)),
                     mesh=make_mesh(1))
    jtr.fit(forever(), evaluator=JaxEvaluator(
        jtr.model, lambda: iter([val]), kw["eval_shape"]))
    tdir = tmp_path / "port"
    tr = Trainer(TrainConfig(**kw, result_dir=str(tdir)), device="cpu")
    ev = Evaluator(tr.model, lambda: iter([val]), kw["eval_shape"],
                   device="cpu")
    tr.fit(forever(), evaluator=ev,
           checkpointer=SnapshotCallback(str(tdir), keep_last=1))

    def keys(d):
        with open(d / "log") as f:
            return [sorted(r) for r in json.load(f)]

    assert keys(tdir) == keys(jdir)
    assert (tdir / "args.txt").exists() and (tdir / "log.jsonl").exists()
    with open(tdir / "log") as f:
        log = json.load(f)
    for r in log:
        if "main/loss" in r:
            assert r["iters_per_sec"] > 0 and r["eta_seconds"] >= 0
            assert 0 < r["progress"] <= 1
        else:
            assert r["val/main/FP"] >= 0 and np.isfinite(r["val/main/loss"])

    path = find_snapshot(str(tdir))
    assert path.endswith("snapshot_iter_4")
    assert not (tdir / "snapshot_iter_2").exists()  # keep_last=1
    assert load_snapshot(path)["step"] == 4
    pred = load_predictor(path)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(pred[k], v), k

    tr2 = Trainer(TrainConfig(**dict(kw, train_iters=6),
                              result_dir=str(tmp_path / "r2")), device="cpu")
    tr2.load_state_dict(load_snapshot(path))
    assert tr2.step == 4
    tr2.fit(forever())
    assert tr2.step == 6
    with open(tmp_path / "r2" / "log") as f:
        assert [r["iteration"] for r in json.load(f)] == [6]


def test_evaluator_matches_jax():
    jcfg = JaxTrainConfig(**tiny())
    state = create_train_state(jcfg, sample_batch_shape=HW)
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    from spalign_tpu.train.trainer import build_model as jax_build

    from spalign_tpu_torch.models.segnet import SegNetBasic

    port = SegNetBasic()
    port.load_state_dict(segnet_state_dict_from_flax(variables, "basic"))
    rng = np.random.RandomState(5)
    imgs = rng.randn(2, *HW, 3).astype(np.float32)
    labels = rng.randint(-1, 2, size=(2, 64, 128)).astype(np.int32)
    want = JaxEvaluator(jax_build(jcfg), lambda: iter([(imgs, labels)]),
                        (64, 128))(variables)
    got = Evaluator(port, lambda: iter([(imgs, labels)]), (64, 128),
                    device="cpu")()
    assert set(got) == set(want)
    n_pix = labels.size
    for k in ("main/FP", "main/FN"):
        assert abs(got[k] - want[k]) <= 1e-3 * n_pix, k
    for k in ("main/iou/road", "main/pixel_accuracy"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    np.testing.assert_allclose(got["main/loss"], want["main/loss"],
                               rtol=1e-4)
    assert port.training  # the evaluator restores the mode


# ---- data ----

class _Items:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), np.int32(i)


def test_prefetch_loader_order_matches_jax():
    def batches(cls):
        return [b[1].tolist() for b in cls(_Items(), 3, shuffle=True,
                                           num_workers=2, epochs=3, seed=7,
                                           drop_last=False)]

    got = batches(PrefetchLoader)
    assert got == batches(JaxPrefetchLoader)
    assert len(got) == 12 and sorted(sum(got[:4], [])) == list(range(11))


def _write_store(kind, tmp_path, arrays):
    if kind == "dir":
        d = tmp_path / "labels"
        d.mkdir()
        for k, v in arrays.items():
            np.save(d / f"{k}.npy", v)
        return str(d)
    if kind == "npz":
        path = tmp_path / "labels.npz"
        np.savez(path, **arrays)
        return str(path)
    path = tmp_path / "labels.zip"
    with zipfile.ZipFile(path, "w") as zf:
        for k, v in arrays.items():
            with zf.open(f"{k}.npy", "w") as f:
                np.save(f, v)
    return str(path)


@pytest.mark.parametrize("kind", ["dir", "zip", "npz"])
def test_npy_store_matches_jax(kind, tmp_path):
    rng = np.random.RandomState(6)
    arrays = {"a_leftImg8bit": rng.rand(4, 6) > 0.5,
              "a_leftImg8bit_scores": rng.rand(2, 4, 6).astype(np.float32),
              "b_leftImg8bit": rng.randint(0, 3, (4, 6)).astype(np.int32)}
    path = _write_store(kind, tmp_path, arrays)
    got, want = _NpyZipStore(path), JaxNpyZipStore(path)
    assert got.names() == want.names() == sorted(arrays)
    for name in got.names():
        np.testing.assert_array_equal(got.load(name), want.load(name))
        np.testing.assert_array_equal(got.load(name), arrays[name])


def test_estimated_dataset_pairs_resizes_and_standardizes(tmp_path):
    images = SyntheticRoadScenes(n=3, full_shape=(32, 64), seed=2)
    masks = {os.path.splitext(images.image_name(i))[0]:
             images[i][1] == SyntheticRoadScenes.ROAD for i in (0, 2)}
    masks["stray_all_cluster"] = np.zeros((32, 64), np.int32)
    path = _write_store("dir", tmp_path, masks)
    ds = EstimatedCityscapesDataset(images, path, (16, 32))
    assert len(ds) == 2
    assert [ds.image_name(i) for i in range(2)] == [images.image_name(0),
                                                    images.image_name(2)]
    img, label = ds[1]
    want = (resize_bicubic_f32(images[2][0].astype(np.float32), (16, 32))
            - CITYSCAPES_MEAN) / CITYSCAPES_STD
    np.testing.assert_allclose(img, want, rtol=1e-6)
    assert label.dtype == np.int32 and label.shape == (16, 32)
    np.testing.assert_array_equal(label, masks[os.path.splitext(
        images.image_name(2))[0]][::2, ::2])
    loader = PrefetchLoader(ds, 2, num_workers=2, epochs=1)
    (bi, bl), = list(loader)
    assert bi.shape == (2, 16, 32, 3) and bl.shape == (2, 16, 32)


def test_estimated_dataset_soft_labels(tmp_path):
    """``*_scores`` members: CHW soft labels become HWC float32 and
    resize nearest with the image."""
    images = SyntheticRoadScenes(n=2, full_shape=(32, 64), seed=3)
    rng = np.random.RandomState(8)
    scores = {os.path.splitext(images.image_name(i))[0] + "_scores":
              rng.rand(2, 32, 64).astype(np.float32) for i in range(2)}
    ds = EstimatedCityscapesDataset(images, _write_store("npz", tmp_path,
                                                         scores),
                                    (16, 32), use_soft_label=True)
    assert len(ds) == 2
    _, label = ds[0]
    want = scores[os.path.splitext(images.image_name(0))[0] + "_scores"]
    assert label.dtype == np.float32 and label.shape == (16, 32, 2)
    np.testing.assert_array_equal(label, want.transpose(1, 2, 0)[::2, ::2])


def test_metrics_match_jax():
    from spalign_tpu.ops import metrics as jm

    from spalign_tpu_torch.ops import metrics as tm

    rng = np.random.RandomState(9)
    pred = rng.randint(0, 3, (2, 20, 30))
    gt = rng.randint(-1, 3, (2, 20, 30))
    want = np.asarray(jm.confusion_matrix(jnp.asarray(pred),
                                          jnp.asarray(gt), 3))
    got = tm.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tm.iou_from_confusion(got).numpy(),
                               np.asarray(jm.iou_from_confusion(
                                   jnp.asarray(want))), rtol=1e-6)
    p, r = tm.precision_recall_from_confusion(got[:2, :2])
    pj, rj = jm.precision_recall_from_confusion(jnp.asarray(want[:2, :2]))
    np.testing.assert_allclose([float(p), float(r)], [float(pj), float(rj)],
                               rtol=1e-6)
