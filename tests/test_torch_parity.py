"""The port's bit-parity mode (kmeans.init='reference') on the CPU.

- ``ops/parity.py`` is the JAX package's copy: equal arrays from equally
  seeded streams.
- The port's parity pipeline from raw images equals, np.array_equal, a
  pure-numpy reference-semantics pipeline built as tests/test_parity.py
  builds it; the one input the two share is the port's DRN feature map.
- Against the JAX package's parity pipeline with the same (converted)
  float32 weights, cluster maps agree on >= 0.99 of the pixels: the two
  DRNs differ by ~1e-4, which can move a near-tie of the Lloyd loop."""

import random

import jax
import numpy as np
import pytest
import torch

from spalign_tpu.config import KMeansConfig as JaxKMeansConfig
from spalign_tpu.config import LabelGenConfig as JaxLabelGenConfig
from spalign_tpu.config import SuperpixelConfig as JaxSuperpixelConfig
from spalign_tpu.ops import parity as jparity
from spalign_tpu.pipeline import label_gen as jlg
from spalign_tpu_torch import config as tcfg
from spalign_tpu_torch.convert.from_jax import drn_state_dict_from_flax
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.ops import parity as tparity
from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator
from tests.reference_oracles import (superpixel_align_np,
                                     superpixel_prior_np,
                                     weighted_kmeans_np)

torch.set_num_threads(2)

BATCH, HW = 4, (112, 112)
ENGINES = {
    "felzenszwalb": dict(method="felzenszwalb", felzenszwalb_scale=100.0,
                         felzenszwalb_sigma=0.8, felzenszwalb_min_size=20),
    "slic": dict(method="slic", n_slic_segments=50, slic_iters=4),
}


def _cfg(module, engine):
    return module["LabelGenConfig"](
        batchsize=BATCH, resize_shape=HW, save_masks=False,
        superpixel=module["SuperpixelConfig"](max_superpixels=512,
                                               **ENGINES[engine]),
        kmeans=module["KMeansConfig"](n_clusters=4, seed=1111,
                                      init="reference"))


PORT = {"LabelGenConfig": tcfg.LabelGenConfig,
        "SuperpixelConfig": tcfg.SuperpixelConfig,
        "KMeansConfig": tcfg.KMeansConfig}
JAX = {"LabelGenConfig": JaxLabelGenConfig,
       "SuperpixelConfig": JaxSuperpixelConfig,
       "KMeansConfig": JaxKMeansConfig}


@pytest.fixture(scope="module")
def images():
    ds = SyntheticRoadScenes(n=BATCH, full_shape=(224, 448), seed=41)
    return ds.resized_batch(range(BATCH), HW)[0]


def _grid_sps(rng, h, w, cell):
    ids = rng.permutation((h // cell) * (w // cell)).reshape(h // cell,
                                                             w // cell)
    return np.repeat(np.repeat(ids, cell, 0), cell, 1)


@pytest.mark.parametrize("append_pos", [True, False])
def test_parity_ops_equal_jax(append_pos):
    rng = np.random.RandomState(5)
    fmap = rng.randn(14, 14, 8).astype(np.float32)
    sps = _grid_sps(rng, 112, 112, 16)
    sps[40:60, 30:90] = 3  # a segment of two parts
    got = tparity.reference_superpixel_align(
        fmap, sps, random.Random(1111), n_select=10, append_pos=append_pos)
    want = jparity.reference_superpixel_align(
        fmap, sps, random.Random(1111), n_select=10, append_pos=append_pos)
    np.testing.assert_array_equal(got, want)
    prior = tparity.superpixel_prior_host(sps, 0.75, 0.5, 0.1, 0.1)
    np.testing.assert_array_equal(
        prior, jparity.superpixel_prior_host(sps, 0.75, 0.5, 0.1, 0.1))
    np.testing.assert_array_equal(tparity.pixel_prior_host(37, 50),
                                  jparity.pixel_prior_host(37, 50))
    # the init stream across consecutive clusterings
    t_rng, j_rng = (np.random.RandomState(1111) for _ in range(2))
    for w in (prior, rng.rand(501), rng.rand(350)):
        np.testing.assert_array_equal(
            tparity.reference_seed_assignment(w, 4, t_rng),
            jparity.reference_seed_assignment(w, 4, j_rng))


def _reference_init_literal(weights, k):
    """The reference's init verbatim (batch_spalign_kmeans.py:141-149),
    on the process-global numpy stream."""
    assign = np.zeros((weights.shape[0],))
    threshold = float(np.sort(weights)[len(weights) // 2])
    cond = weights <= threshold
    idx = np.arange(int(cond.sum())) % (k - 1) + 1
    np.random.shuffle(idx)
    assign[cond] = idx
    return assign.astype(np.int32)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_pipeline_masks_equal_numpy_oracle(engine, images):
    """From raw images: the port's parity run_batch against the numpy
    pipeline (seed-1111 python anchor shuffle -> align -> float64 prior ->
    seed-1111 numpy init -> Lloyd -> painting), np.array_equal."""
    cfg = _cfg(PORT, engine)
    gen = SpalignLabelGenerator(cfg, device="cpu")
    assert next(gen.model.parameters()).dtype == torch.float32
    road, cluster, diag, timers = gen.run_batch(images)
    road, cluster = road.numpy(), cluster.numpy()
    assert not diag["kmeans_empty_stop"]  # no retry consumed the stream
    assert {"time_features", "time_align", "time_prior"} <= set(
        timers.times)

    prepared = SpalignLabelGenerator(cfg, device="cpu")._host_prepare(images)
    fmaps = gen.features(prepared["wire"]).numpy()
    sps, counts = prepared["sps_host"], prepared["counts"]
    random.seed(1111)
    X = np.concatenate([
        superpixel_align_np(fmaps[i].transpose(2, 0, 1), sps[i],
                            n_select=cfg.align.n_anchors,
                            append_pos=cfg.align.append_pos)
        for i in range(BATCH)]).astype(np.float32)
    weights = np.concatenate([superpixel_prior_np(s) for s in sps])
    np.random.seed(1111)
    assign0 = _reference_init_literal(weights, k=4)
    assign, _, _ = weighted_kmeans_np(X, weights.astype(np.float32), 4,
                                      assign0, n_iter=cfg.kmeans.n_iter)
    o = 0
    for i in range(BATCH):
        want = assign[o:o + counts[i]][sps[i]]
        o += int(counts[i])
        np.testing.assert_array_equal(cluster[i], want)
        np.testing.assert_array_equal(road[i], want == 0)


def test_pipeline_agrees_with_jax():
    """The JAX package's parity pipeline and the port's with its weights
    (float32 both; the RNG replicas from the same seed)."""
    ds = SyntheticRoadScenes(n=BATCH, full_shape=(224, 448), seed=43)
    images = ds.resized_batch(range(BATCH), HW)[0]
    jgen = jlg.SpalignLabelGenerator(_cfg(JAX, "felzenszwalb"))
    j_road, j_cluster, j_diag, _ = jgen.run_batch(images)
    sd = drn_state_dict_from_flax(jax.device_get(jgen.variables))
    tgen = SpalignLabelGenerator(_cfg(PORT, "felzenszwalb"), state_dict=sd,
                                 device="cpu")
    road, cluster, diag, _ = tgen.run_batch(images)
    assert diag["n_superpixels"] == j_diag["n_superpixels"]
    assert (cluster.numpy() == np.asarray(j_cluster)).mean() >= 0.99
    assert (road.numpy() == np.asarray(j_road)).mean() >= 0.99
