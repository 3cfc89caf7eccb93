"""The port's host library (spalign_tpu_torch/csrc/host_ops.cpp through
spalign_tpu_torch/native.py) against the JAX package's, on the CPU.

Both compile the same source with the same g++ flags, so felzenszwalb and
connectivity maps and the scorer's counts are equal exactly.  The plain
numpy versions are held to the rules of tests/test_superpixels.py: the
same partition without the blur (sigma = 0) and segment counts within 1
with it (the two blurs round differently)."""

import importlib

import numpy as np
import pytest
import torch

from spalign_tpu import native as jnative
from spalign_tpu.pipeline import label_gen as jlg
from spalign_tpu_torch import native
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.kernels import _build
from spalign_tpu_torch.kernels.slic import slic
from spalign_tpu_torch.pipeline import label_gen as tlg

PARAMS = [(300.0, 0.8, 20), (100.0, 0.8, 20), (1.0, 0.0, 5)]


def _scene(shape, seed=5):
    img, _ = SyntheticRoadScenes(n=1, full_shape=shape, seed=seed)[0]
    return img.astype(np.float32) / 255.0


def _same_partition(a, b):
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return len(pairs) == len({p[0] for p in pairs}) == len(
        {p[1] for p in pairs})


@pytest.mark.parametrize("shape", [(224, 224), (112, 224)])
@pytest.mark.parametrize("params", PARAMS, ids=lambda p: "-".join(map(str, p)))
def test_felzenszwalb_equals_jax(shape, params):
    img = _scene(shape)
    got = native.felzenszwalb(img, *params)
    want = jnative.felzenszwalb(img, *params)
    assert got.dtype == np.int32 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == set(range(got.max() + 1))


@pytest.mark.parametrize("min_size", [1, 20, 196])
def test_enforce_connectivity_equals_jax(min_size):
    """On device SLIC maps (the plain version on the CPU; disconnected
    labels happen) and on random labels."""
    img = torch.from_numpy((_scene((96, 128)) * 255).astype(np.uint8))
    sps = slic(img[None], n_segments=30, n_iter=4, device="cpu")[0].numpy()
    noise = np.random.RandomState(min_size).randint(0, 5, (40, 56))
    for labels in (sps, noise):
        got = native.enforce_connectivity(labels, min_size=min_size)
        want = jnative.enforce_connectivity(labels, min_size=min_size)
        np.testing.assert_array_equal(got, want)


def test_plain_versions_agree():
    img = np.zeros((24, 24, 3), np.float32)
    img[:, 12:] = 0.9
    img[16:, :6] = 0.5
    got = native.felzenszwalb_reference(img, scale=1.0, sigma=0.0,
                                        min_size=5)
    assert _same_partition(got, native.felzenszwalb(img, 1.0, 0.0, 5))
    small = _scene((96, 96))[:48, :48]
    got = native.felzenszwalb_reference(small, 100.0, 0.8, 10)
    want = native.felzenszwalb(small, 100.0, 0.8, 10)
    assert abs(int(got.max()) - int(want.max())) <= 1
    labels = np.random.RandomState(3).randint(0, 4, (16, 16))
    np.testing.assert_array_equal(
        native.enforce_connectivity_reference(labels, 1),
        native.enforce_connectivity(labels, 1))
    merged = native.enforce_connectivity_reference(labels, 6)
    assert np.bincount(merged.ravel()).min() >= 6


@pytest.mark.parametrize("small,full", [((112, 112), (256, 512)),
                                        ((28, 28), (1024, 2048)),
                                        ((37, 50), (100, 301)),
                                        ((256, 512), (256, 512))])
def test_scorer_equals_reference_and_jax(small, full):
    rng = np.random.RandomState(sum(full))
    mask = rng.rand(*small) < 0.4
    label_ids = rng.randint(0, 34, full).astype(np.uint8)
    label_ids[rng.rand(*full) < 0.3] = 7
    got = native.confusion_vs_labelids(mask, label_ids)
    assert got.dtype == np.int64 and got.shape == (2, 2)
    np.testing.assert_array_equal(
        got, tlg.host_confusion_reference(mask, label_ids))
    np.testing.assert_array_equal(got, jlg.host_confusion(mask, label_ids))
    np.testing.assert_array_equal(got, tlg.host_confusion(mask, label_ids))


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    lib = _build.HostLibrary("host_ops", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        lib.get()


def test_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """A source g++ refuses: RuntimeError with the compiler's output, no
    library, and the bindings raise too (no numpy path behind them)."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cpp").write_text(
        'extern "C" int f() { return not_declared; }\n')
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    broken = _build.HostLibrary("broken", {})
    with pytest.raises(RuntimeError, match="not_declared"):
        broken.get()
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "LIBRARY", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.felzenszwalb(_scene((32, 32)))
    with pytest.raises(RuntimeError):
        native.confusion_vs_labelids(np.ones((4, 4), bool),
                                     np.ones((8, 8), np.uint8))


def test_library_name_carries_the_target(monkeypatch):
    """A library built for another CPU is never loaded: -march=native's
    resolved options are in the file name's hash."""
    lib = _build.HostLibrary("host_ops", {})
    assert b"-march=" in lib.target()
    here = lib._build()
    monkeypatch.setattr(_build.HostLibrary, "target",
                        lambda self: b"-march= another")
    monkeypatch.setattr(_build.subprocess, "run", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("built")))
    with pytest.raises(AssertionError, match="built"):
        lib._build()
    assert here.exists()


def test_golden_hash_equals_jax():
    """The constant chip_smoke.py checks on the card is the JAX package's
    own library's (and the port's) on this machine."""
    smoke = importlib.import_module("chip_smoke")
    frames = smoke.golden_frames()
    assert frames.shape == (4, 256, 512, 3) and frames.dtype == np.uint8
    assert smoke.sha256(frames) == smoke.GOLDEN_FRAMES_SHA256
    want = smoke.felzenszwalb_maps(jnative.felzenszwalb, frames)
    assert smoke.sha256(want) == smoke.GOLDEN_MAPS_SHA256
    got = smoke.felzenszwalb_maps(native.felzenszwalb, frames)
    assert smoke.sha256(got) == smoke.GOLDEN_MAPS_SHA256
