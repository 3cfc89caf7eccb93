"""The port's relabel pass (spalign_tpu_torch/selftrain/relabel.py) and its
three host-library passes (native.one_minus_f16, confusion_remapped,
standardize_invert_u8) against the JAX package's, on the CPU.

Both packages relabel the same tiny zipped Cityscapes set (the port's
reader hands both the same arrays) with the same weights: a SegNetBasic
trained 30 Adam steps by the JAX package (as the JAX package's yuv420
gate trains it) and carried over with
convert/from_jax.py.

The pass is held to JAX's in two parts.  The pipeline (wires, softmax,
upsample, argmax, casts, channel 1, the stores, the records) runs in
both packages around a network without pooling (a linear map of each
pixel, the same weights in both), so that only the pipelines differ:
PRED members agree on >= 0.999 of the pixels of every image,
channel 0 of the scores within 1e-4 in float32 and one float16 ulp in
float16, channel 1 of each package equal to 1 - its channel 0 bit for
bit, the per-image metrics within 1e-4.  With the port's SegNetBasic, the PREDs
agree on >= 0.999 of the pixels of the set: SegNet's argmax pooling
makes the network discontinuous, and where two values of a pooling
window lie within float32 noise of each other the two packages may pick
different positions (on these scenes: one window of one image, which
moves that image's scores around it; the network's own parity on
inputs without such near-ties is tests/test_torch_segnet.py's, 1e-4).  The wires u8 and auto equal f32
exactly; yuv420 against u8 at the gate of
tests/test_selftrain.py::test_relabel_yuv420_wire_prediction_agreement;
the host-library passes bit-equal to their plain versions and to the
JAX package's library."""

import glob
import os
import zipfile

import cv2
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from spalign_tpu import native as jnative
from spalign_tpu.config import TrainConfig as JaxTrainConfig
from spalign_tpu.models import SegNetBasic as JaxSegNetBasic
from spalign_tpu.selftrain.relabel import relabel_dataset as jax_relabel
from spalign_tpu.train.trainer import create_train_state, make_train_step
from spalign_tpu_torch import native
from spalign_tpu_torch.convert.from_jax import segnet_state_dict_from_flax
from spalign_tpu_torch.data.cityscapes import (CITYSCAPES_MEAN,
                                               CITYSCAPES_STD,
                                               ZippedCityscapesRoadDataset)
from spalign_tpu_torch.data.estimated import (EstimatedCityscapesDataset,
                                              _NpyZipStore)
from spalign_tpu_torch.data.png import encode_png, write_png
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.models.segnet import SegNetBasic, build_segnet
from spalign_tpu_torch.selftrain.relabel import (NpzShardWriter,
                                                 relabel_dataset)

torch.set_num_threads(2)
N = 8
HW = (64, 128)  # network input
EVAL = (128, 256)  # eval resolution: the scenes' full resolution


@pytest.fixture(scope="module")
def trained():
    """(flax variables, the port's state_dict) of a SegNetBasic trained
    30 Adam steps on 8 synthetic scenes at 64x128, as the JAX package's
    yuv420 gate trains it."""
    ds = SyntheticRoadScenes(n=N, full_shape=HW, seed=13)
    imgs = np.stack([(ds[i][0].astype(np.float32) - CITYSCAPES_MEAN)
                     / CITYSCAPES_STD for i in range(N)])
    labs = np.stack([(ds[i][1] == 7).astype(np.int32) for i in range(N)])
    cfg = JaxTrainConfig(model="basic", optimizer="Adam", input_shape=HW,
                         eval_shape=HW, batchsize=N, loss="ce")
    state = create_train_state(cfg, sample_batch_shape=HW)
    step = make_train_step(cfg)
    for _ in range(30):
        state, m = step(state, jnp.asarray(imgs), jnp.asarray(labs))
    assert float(m["loss"]) < 0.3, float(m["loss"])  # it learned
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    return variables, segnet_state_dict_from_flax(variables, "basic")


@pytest.fixture(scope="module")
def zipped(tmp_path_factory):
    """The port's ZippedCityscapesRoadDataset over a fake zip pair of N
    scenes at EVAL, read at HW (standardized) with gt at EVAL."""
    root = tmp_path_factory.mktemp("relabel_zips")
    ds = SyntheticRoadScenes(n=N, full_shape=EVAL, seed=13)
    img_zip, lab_zip = str(root / "imgs.zip"), str(root / "labs.zip")
    with zipfile.ZipFile(img_zip, "w") as zi, \
            zipfile.ZipFile(lab_zip, "w") as zl:
        for i in range(N):
            img, lab = ds[i]
            key = f"aachen_000000_{i:06d}"
            zi.writestr(f"leftImg8bit/train/aachen/{key}_leftImg8bit.png",
                        encode_png(img))
            zl.writestr(f"gtFine/train/aachen/{key}_gtFine_labelIds.png",
                        encode_png(lab))
    return ZippedCityscapesRoadDataset(img_zip, lab_zip, HW)


class _JaxPixelNet(flax.linen.Module):
    """Logits = a fixed linear map of each pixel's three channels: a
    network without pooling, so that the two packages' scores differ by
    float32 rounding only and the comparison sees the pipelines."""

    @flax.linen.compact
    def __call__(self, x, train=False):
        return flax.linen.Dense(2)(x)


def _pixel_nets():
    """(JAX module, its variables, the port's torch module) with the same
    weights."""
    net = _JaxPixelNet()
    variables = net.init(jax.random.key(3), jnp.zeros((1, 3)))
    params = jax.device_get(variables["params"]["Dense_0"])
    port = torch.nn.Linear(3, 2)
    with torch.no_grad():
        port.weight.copy_(torch.tensor(np.asarray(params["kernel"]).T))
        port.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    return net, variables, port


def _port_model(sd):
    model = SegNetBasic()
    model.load_state_dict(sd)
    return model


def _read(out_zip):
    preds, scores = {}, {}
    with np.load(out_zip) as npz:
        for k in npz.files:
            (scores if k.endswith("_scores") else preds)[k] = npz[k]
    return preds, scores


def _run_port(tmp, tag, model, dataset, **kw):
    """The port's relabel_dataset with ``model`` (a module, or a port
    state_dict for SegNetBasic)."""
    out = str(tmp / f"port_{tag}.0.zip")
    kw = {"eval_shape": EVAL, "batch_size": 3, "soft_label": True, **kw}
    if isinstance(model, dict):
        model = _port_model(model)
    recs = relabel_dataset(model, None, dataset, out, device="cpu", **kw)
    return recs, *_read(out)


@pytest.fixture(scope="module")
def jax_runs(trained, zipped, tmp_path_factory):
    """JAX relabel_dataset's outputs, keyed by (network, score dtype,
    store): "segnet" is the trained SegNetBasic, "pixel" the pixel net."""
    tmp = tmp_path_factory.mktemp("jax_relabel")
    pixel, pixel_vars, _ = _pixel_nets()
    out = {}
    for net, model, variables, dtype, store in [
            ("segnet", JaxSegNetBasic(n_class=2), trained[0], np.float32,
             "eval"),
            ("pixel", pixel, pixel_vars, np.float32, "eval"),
            ("pixel", pixel, pixel_vars, np.float16, "eval"),
            ("pixel", pixel, pixel_vars, np.float16, "network")]:
        dtype = np.dtype(dtype).name
        path = str(tmp / f"{net}_{dtype}_{store}.0.zip")
        recs = jax_relabel(model, variables, zipped, path, eval_shape=EVAL,
                           batch_size=3, soft_label=True, score_dtype=dtype,
                           score_store=store)
        out[net, dtype, store] = (recs, *_read(path))
    return out


def _f16_ulp(a, b):
    """One float16 ulp at the larger magnitude of a and b."""
    m = np.maximum(np.abs(a), np.abs(b)).astype(np.float16)
    return np.spacing(m).astype(np.float32)


def _assert_preds_agree(got, want):
    assert set(got) == set(want) and len(got) == N
    for k in want:
        assert got[k].shape == want[k].shape == EVAL
        assert got[k].dtype == bool
        assert np.mean(got[k] == want[k]) >= 0.999, k


@pytest.mark.parametrize("dtype,store", [("float32", "eval"),
                                         ("float16", "eval"),
                                         ("float16", "network")])
def test_relabel_pipeline_matches_jax(zipped, jax_runs, tmp_path, dtype,
                                      store):
    recs, preds, scores = _run_port(tmp_path, "m", _pixel_nets()[2],
                                    zipped, score_dtype=np.dtype(dtype),
                                    score_store=store)
    jrecs, jpreds, jscores = jax_runs["pixel", dtype, store]
    _assert_preds_agree(preds, jpreds)
    assert set(scores) == set(jscores) and len(scores) == N
    shape = (2, *EVAL) if store == "eval" else (2, *HW)
    for k in jscores:
        a, b = scores[k], jscores[k]
        assert a.shape == b.shape == shape and a.dtype == b.dtype == dtype
        for s in (a, b):  # channel 1 is rebuilt from channel 0
            np.testing.assert_array_equal(s[1], (1.0 - s[0].astype(
                np.float32)).astype(s.dtype))
        a, b = a[0].astype(np.float32), b[0].astype(np.float32)
        tol = 1e-4 if dtype == "float32" else _f16_ulp(a, b)
        assert np.all(np.abs(a - b) <= tol), k
    assert [r["img_fn"] for r in recs] == [r["img_fn"] for r in jrecs]
    for r, jr in zip(recs, jrecs):
        for key in ("road_iou", "non_road_iou", "precision", "recall"):
            assert abs(r[key] - jr[key]) <= 1e-4, key
        assert all(k.startswith("time_") for k in set(r) - set(jr))


def test_relabel_with_port_network_matches_jax(trained, zipped, jax_runs,
                                               tmp_path):
    """The whole pass with the port's SegNetBasic: PREDs agree on >=
    0.999 of the set's pixels, road IoU within 1e-3 an image (a flipped
    pixel moves it by ~1e-4)."""
    recs, preds, _ = _run_port(tmp_path, "net", trained[1], zipped,
                               score_dtype=np.float32)
    jrecs, jpreds, _ = jax_runs["segnet", "float32", "eval"]
    assert set(preds) == set(jpreds) and len(preds) == N
    agree = np.mean([preds[k] == jpreds[k] for k in jpreds])
    assert agree >= 0.999, agree
    for r, jr in zip(recs, jrecs):
        assert r["img_fn"] == jr["img_fn"]
        assert abs(r["road_iou"] - jr["road_iou"]) <= 1e-3


def test_score_store_network_against_eval(trained, zipped, tmp_path):
    """The PRED members and the records are the same in both stores; the
    eval store is the bilinear upsample of the network store (to the
    float16 quantum)."""
    sd = trained[1]
    recs_e, preds_e, scores_e = _run_port(tmp_path, "e", sd, zipped,
                                          score_dtype=np.float16)
    recs_n, preds_n, scores_n = _run_port(tmp_path, "n", sd, zipped,
                                          score_dtype=np.float16,
                                          score_store="network")
    assert set(preds_e) == set(preds_n)
    for k in preds_e:
        np.testing.assert_array_equal(preds_e[k], preds_n[k])
        s = k + "_scores"
        assert scores_n[s].shape == (2, *HW)
        up = F.interpolate(torch.from_numpy(
            scores_n[s].astype(np.float32))[None], size=EVAL,
            mode="bilinear", align_corners=False)[0].numpy()
        np.testing.assert_allclose(scores_e[s].astype(np.float32), up,
                                   atol=2e-3)
    strip = [{k: v for k, v in r.items() if not k.startswith("time_")}
             for r in recs_e]
    assert strip == [{k: v for k, v in r.items()
                      if not k.startswith("time_")} for r in recs_n]


@pytest.mark.parametrize("wire", ["u8", "auto"])
def test_u8_and_auto_wires_equal_f32(trained, zipped, tmp_path, wire):
    """The uint8 wire standardizes on the device with the arithmetic the
    reader used: the same float32 inputs, so the same outputs."""
    sd = trained[1]
    _, p32, s32 = _run_port(tmp_path, "f32", sd, zipped, input_wire="f32")
    _, pw, sw = _run_port(tmp_path, wire, sd, zipped, input_wire=wire)
    for k in p32:
        np.testing.assert_array_equal(pw[k], p32[k])
        np.testing.assert_array_equal(sw[k + "_scores"], s32[k + "_scores"])


class _Adapter:
    """(standardized image, gt in {0, 1}) of synthetic scenes."""

    def __init__(self, ds, names=None):
        self.ds, self.names = ds, names

    def __len__(self):
        return len(self.ds)

    def image_name(self, i):
        return self.names[i] if self.names else self.ds.image_name(i)

    def __getitem__(self, i):
        img, lab = self.ds[i]
        img = (img.astype(np.float32) - CITYSCAPES_MEAN) / CITYSCAPES_STD
        return img, (lab == 7).astype(np.int32)


def test_yuv420_wire_prediction_agreement(trained, tmp_path):
    """The yuv420 wire against the exact u8 wire on the trained net, at
    the gate of the JAX package's test: per-image agreement >= 0.98, mean
    |score delta| < 0.04, >= 95% of the flipped pixels within 3 px of a
    predicted class boundary."""
    adapter = _Adapter(SyntheticRoadScenes(n=N, full_shape=HW, seed=13))
    runs = {}
    for wire in ("u8", "yuv420"):
        _, preds, scores = _run_port(tmp_path, wire, trained[1], adapter,
                                     eval_shape=HW, batch_size=4,
                                     input_wire=wire)
        runs[wire] = preds, scores
    (pu8, su8), (pyv, syv) = runs["u8"], runs["yuv420"]
    agrees, deltas, n_flip, n_near = [], [], 0, 0
    for k in pu8:
        agrees.append(float(np.mean(pu8[k] == pyv[k])))
        deltas.append(float(np.abs(su8[k + "_scores"][1]
                                   - syv[k + "_scores"][1]).mean()))
        flipped = pu8[k] != pyv[k]
        if flipped.any():
            p = pu8[k]
            edge = np.zeros_like(p)
            edge[:-1] |= p[:-1] != p[1:]
            edge[1:] |= p[:-1] != p[1:]
            edge[:, :-1] |= p[:, :-1] != p[:, 1:]
            edge[:, 1:] |= p[:, :-1] != p[:, 1:]
            near = cv2.dilate(edge.astype(np.uint8),
                              np.ones((7, 7), np.uint8)).astype(bool)
            n_flip += int(flipped.sum())
            n_near += int((near & flipped).sum())
    assert min(agrees) >= 0.98, agrees
    assert max(deltas) < 0.04, deltas
    if n_flip:
        assert n_near / n_flip >= 0.95, (n_near, n_flip)


def test_yuv420_mixed_resolution_batches(tmp_path):
    """Each batch decodes at its own resolution: a mixed-resolution run
    equals the same images relabeled in single-resolution runs (the
    producer loads batch k+2 while batch k is dispatched)."""
    sd = build_segnet(device="cpu").state_dict()
    a = SyntheticRoadScenes(n=4, full_shape=(64, 128), seed=23)
    b = SyntheticRoadScenes(n=4, full_shape=(128, 64), seed=24)

    class Mixed:
        def __init__(self, parts):
            self.parts = [(tag, ds, i) for tag, ds in parts
                          for i in range(len(ds))]

        def __len__(self):
            return len(self.parts)

        def image_name(self, i):
            return f"{self.parts[i][0]}_{self.parts[i][2]:02d}.png"

        def __getitem__(self, i):
            _, ds, j = self.parts[i]
            return _Adapter(ds)[j]

    def run(tag, parts):
        _, preds, scores = _run_port(tmp_path, tag, sd, Mixed(parts),
                                     eval_shape=(64, 128), batch_size=4,
                                     score_dtype=np.float16,
                                     input_wire="yuv420", prefetch=2)
        return {**preds, **scores}

    mixed = run("mixed", [("a", a), ("b", b)])
    solo = {**run("solo_a", [("a", a)]), **run("solo_b", [("b", b)])}
    assert set(mixed) == set(solo)
    for k in mixed:
        np.testing.assert_array_equal(mixed[k], solo[k], err_msg=k)


def test_save_each_layout(trained, zipped, tmp_path):
    """--save_each: per-image <name>.npy and <name>_scores.npy files, the
    scores being scores (the reference stores the PRED there)."""
    out_dir = str(tmp_path / "each")
    unused = str(tmp_path / "unused.0.zip")
    recs = relabel_dataset(_port_model(trained[1]), None, zipped, unused,
                           eval_shape=EVAL, batch_size=4, out_dir=out_dir,
                           save_each=True, score_dtype=np.float16,
                           device="cpu")
    assert len(recs) == N and not os.path.exists(unused)
    preds = sorted(glob.glob(os.path.join(out_dir, "*leftImg8bit.npy")))
    scores = sorted(glob.glob(os.path.join(out_dir, "*_scores.npy")))
    assert len(preds) == len(scores) == N
    assert os.path.exists(os.path.join(out_dir, "result.json"))
    p, s = np.load(preds[0]), np.load(scores[0])
    assert p.dtype == bool and p.shape == EVAL
    assert s.dtype == np.float16 and s.shape == (2, *EVAL)
    np.testing.assert_allclose(s.astype(np.float32).sum(0), 1.0, atol=2e-3)


def test_f16_scores_on_disk_round_trip(trained, zipped, tmp_path):
    """float16 scores at the network resolution, channel 1 = 1 - ch0 bit
    for bit, read back by the training reader as float32 (H, W, 2)."""
    out = str(tmp_path / "soft.0.zip")
    recs = relabel_dataset(_port_model(trained[1]), None, zipped, out,
                           eval_shape=EVAL, batch_size=3,
                           score_dtype=np.float16, score_store="network",
                           device="cpu")
    assert len(recs) == N and all("road_iou" in r for r in recs)
    preds, scores = _read(out)
    for s in scores.values():
        assert s.dtype == np.float16 and s.shape == (2, *HW)
        np.testing.assert_array_equal(
            s[1].view(np.uint16),
            native.one_minus_f16_reference(s[0]).view(np.uint16))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(N):
        name = os.path.basename(zipped.image_name(i))
        write_png(str(img_dir / name),
                  np.zeros((*EVAL, 3), np.uint8))
    train_ds = EstimatedCityscapesDataset(str(img_dir), out, HW,
                                          use_soft_label=True)
    assert len(train_ds) == N
    _, soft = train_ds[0]
    assert soft.dtype == np.float32 and soft.shape == (*HW, 2)
    np.testing.assert_allclose(soft.sum(-1), 1.0, atol=2e-3)


def test_npz_shard_writer_readers(tmp_path):
    path = str(tmp_path / "w.0.zip")
    arrays = {"a": np.arange(6).reshape(2, 3) > 2,
              "a_scores": np.linspace(0, 1, 12, dtype=np.float16).reshape(
                  2, 2, 3)}
    w = NpzShardWriter(path)
    for k, v in arrays.items():
        w.put(k, v)
    w.close()
    store = _NpyZipStore(path)
    assert store.names() == sorted(arrays)
    with np.load(path) as npz:
        for k, v in arrays.items():
            np.testing.assert_array_equal(npz[k], v)
            np.testing.assert_array_equal(store.load(k), v)
    w = NpzShardWriter(str(tmp_path / "bad.0.zip"))
    w.put("obj", np.array([object()]))  # not writable without pickle
    with pytest.raises(ValueError):
        w.close()


def test_unported_options_raise(zipped, tmp_path):
    """save_panels and relabel over a process group raised
    NotImplementedError before they were ported.  save_panels without
    out_dir now warns and writes no panel (the JAX package's rule), and
    under a process group (here a one-rank gloo group) relabel writes the
    zip a run without one writes; tests/test_torch_sharded.py holds 2
    ranks to one."""
    model = build_segnet(device="cpu")
    with pytest.warns(UserWarning, match="save_panels needs out_dir"):
        relabel_dataset(model, None, zipped, str(tmp_path / "p.0.zip"),
                        save_panels=True, eval_shape=EVAL, device="cpu")
    assert not glob.glob(str(tmp_path / "*.png"))
    relabel_dataset(model, None, zipped, str(tmp_path / "one.0.zip"),
                    eval_shape=EVAL, device="cpu")
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                             rank=0, world_size=1)
    try:
        relabel_dataset(model, None, zipped, str(tmp_path / "s.0.zip"),
                        eval_shape=EVAL, device="cpu")
    finally:
        tdist.destroy_process_group()
    with zipfile.ZipFile(tmp_path / "one.0.zip") as a, \
            zipfile.ZipFile(tmp_path / "s.0.zip") as b:
        assert a.namelist() == b.namelist()
        assert all(a.read(m) == b.read(m) for m in a.namelist())


def _inputs(name, rng):
    if name == "one_minus_f16":
        every = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
        return (np.concatenate([every[~np.isnan(every)],
                                rng.rand(4096).astype(np.float16)]),)
    if name == "confusion_remapped":
        return (rng.rand(96, 160) > 0.5,
                rng.randint(-3, 4, (96, 160)).astype(np.int32))
    pixels = rng.randint(0, 256, (2, 24, 40, 3)).astype(np.float32)
    std = ((pixels - CITYSCAPES_MEAN) / CITYSCAPES_STD).astype(np.float32)
    return std, CITYSCAPES_MEAN, CITYSCAPES_STD


@pytest.mark.parametrize("name", ["one_minus_f16", "confusion_remapped",
                                  "standardize_invert_u8"])
def test_native_relabel_passes(name):
    """Bit-equal to the plain numpy version (every non-NaN float16 for
    one_minus_f16; for standardize_invert_u8 also on random floats,
    rounding ties included) and to the JAX package's library."""
    rng = np.random.RandomState(0)
    args = _inputs(name, rng)
    got = getattr(native, name)(*args)
    plain = getattr(native, name + "_reference")(*args)
    theirs = getattr(jnative, name)(*args)
    assert got.dtype == plain.dtype == theirs.dtype
    if got.dtype == np.float16:
        got, plain, theirs = (a.view(np.uint16) for a in (got, plain, theirs))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, theirs)
    if name == "standardize_invert_u8":
        floats = ((rng.rand(4, 100, 200, 3) * 300 - 20).astype(np.float32)
                  - CITYSCAPES_MEAN) / CITYSCAPES_STD
        np.testing.assert_array_equal(
            native.standardize_invert_u8(floats, *args[1:]),
            native.standardize_invert_u8_reference(floats, *args[1:]))
