"""The host superpixel engines in the port (spalign_tpu_torch/pipeline/
superpixels.py, and the spalign and overlaps generators on them) against
the JAX package, on the CPU.

Tolerances: felzenszwalb maps and counts are equal (one C++ source, one
set of flags); the connectivity pass on JAX's SLIC labels equals JAX's
exactly, and the whole SLIC engine agrees on >= 0.995 of the pixels (the
bar of the device SLIC tests); a host-engine unit with JAX's draws
agrees with JAX's on >= 0.99 of the pixels (the DRN features differ by
float rounding); road IoU of a whole run within 0.1 with the port's own
draws; overlaps masks agree on >= 0.99 of the pixels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.config import LabelGenConfig as JaxLabelGenConfig
from spalign_tpu.config import SuperpixelConfig as JaxSuperpixelConfig
from spalign_tpu.data.synthetic import SyntheticRoadScenes
from spalign_tpu.kernels.slic import slic as jax_slic
from spalign_tpu.pipeline import direct as jdirect
from spalign_tpu.pipeline import label_gen as jlg
from spalign_tpu.pipeline.superpixels import \
    compute_superpixels as jax_compute_superpixels
from spalign_tpu.utils.timers import StageTimer as JaxStageTimer
from spalign_tpu_torch import config as tcfg
from spalign_tpu_torch import native
from spalign_tpu_torch.convert.from_jax import drn_state_dict_from_flax
from spalign_tpu_torch.ops.segments import anchor_key_bits
from spalign_tpu_torch.pipeline import direct as tdirect
from spalign_tpu_torch.pipeline import label_gen as tlg
from spalign_tpu_torch.pipeline.superpixels import compute_superpixels

torch.set_num_threads(2)

HW = (112, 112)
FULL = (128, 256)
B = 3
S = 128
ENGINES = {
    "felzenszwalb": dict(method="felzenszwalb", felzenszwalb_scale=100.0,
                         max_superpixels=S),
    "slic_connectivity": dict(method="slic", n_slic_segments=40,
                              slic_iters=4, max_superpixels=S),
}
COMMON = dict(batchsize=B, resize_shape=HW, model_dtype="float32",
              save_masks=False)


def _cfgs(engine, **kw):
    sp = ENGINES[engine]
    return (JaxLabelGenConfig(superpixel=JaxSuperpixelConfig(**sp),
                              **dict(COMMON, **kw)),
            tcfg.LabelGenConfig(superpixel=tcfg.SuperpixelConfig(**sp),
                                **dict(COMMON, **kw)))


@pytest.fixture(scope="module")
def scenes():
    ds = SyntheticRoadScenes(n=2 * B, full_shape=FULL, seed=23)
    imgs, labels = ds.resized_batch(range(2 * B), HW)
    full = np.stack([ds[i][0] for i in range(2 * B)])
    return ds, imgs, full


@pytest.fixture(scope="module")
def jgen():
    """JAX's spalign generator on the host-engine path: its program takes
    the maps of either engine (same S)."""
    return jlg.SpalignLabelGenerator(_cfgs("felzenszwalb")[0], seed=3)


@pytest.fixture(scope="module")
def state_dict(jgen):
    return drn_state_dict_from_flax(jax.device_get(jgen.variables))


@pytest.mark.parametrize("shape", [HW, FULL])
def test_felzenszwalb_engine_equals_jax(scenes, shape):
    ds, imgs, full = scenes
    batch = imgs if shape == HW else full
    jcfg, tcfg_ = _cfgs("felzenszwalb")
    got, counts = compute_superpixels(batch, tcfg_.superpixel, device="cpu")
    want, want_counts = jax_compute_superpixels(batch, jcfg.superpixel)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counts, want_counts)
    assert got.dtype == np.int32 and counts.max() <= S
    with pytest.raises(ValueError, match="max_superpixels"):
        compute_superpixels(batch, dataclasses.replace(
            tcfg_.superpixel, max_superpixels=int(counts.max()) - 1),
            device="cpu")


def test_slic_connectivity_engine_equals_jax(scenes):
    _, imgs, _ = scenes
    jcfg, tcfg_ = _cfgs("slic_connectivity")
    want, want_counts = jax_compute_superpixels(imgs, jcfg.superpixel)
    raw = np.asarray(jax.vmap(lambda im: jax_slic(
        im, n_segments=40, n_iter=4))(jnp.asarray(imgs)))
    min_size = HW[0] * HW[1] // (40 * 4)
    on_jax_labels = np.stack([native.enforce_connectivity(r, min_size)
                              for r in raw])
    np.testing.assert_array_equal(on_jax_labels, want)
    got, counts = compute_superpixels(imgs, tcfg_.superpixel, device="cpu")
    assert (got == want).mean() >= 0.995
    assert abs(counts.astype(int) - want_counts).max() <= 1
    for m, n in zip(got, counts):
        assert set(np.unique(m)) == set(range(n))


def _jax_draws(seeds, b, hw, s):
    """The anchor bits and seeding uniforms of jlg._align_and_prior."""
    avail = anchor_key_bits(s)
    bits, unif = [], []
    for seed in seeds:
        k_align, k_seed = jax.random.split(jax.random.key(seed))
        for k in jax.random.split(k_align, b):
            bits.append(np.array(jax.random.randint(
                k, (hw,), 0, 2 ** avail, dtype=jnp.int32)))
        unif.append(np.array(jax.random.uniform(k_seed, (b * s,))))
    return tlg.UnitDraws(torch.from_numpy(np.stack(bits)),
                         torch.from_numpy(np.stack(unif)))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_host_engine_unit_matches_jax_with_its_draws(engine, scenes, jgen,
                                                     state_dict):
    """One unit of 2 groups: each engine's maps through JAX's program and
    through the port's run_unit with JAX's draws (K = max_superpixels)."""
    _, imgs, _ = scenes
    jcfg, tcfg_ = _cfgs(engine, groups_per_dispatch=2)
    sps_j, counts_j = jax_compute_superpixels(imgs, jcfg.superpixel)
    seeds = np.asarray([11, 22], np.uint32)
    road, packed, cluster, assign, res, ok = jax.device_get(
        jgen._fused_program()(jnp.asarray(imgs), jnp.asarray(sps_j), seeds,
                              np.int32(4)))
    tgen = tlg.SpalignLabelGenerator(tcfg_, state_dict=state_dict,
                                     device="cpu")
    assert tgen.num_segments == S
    prep = tgen._host_prepare(imgs)
    assert (prep["sps_host"] == sps_j).mean() >= 0.995
    assert prep["sps"].dtype == torch.uint8  # narrowed for the upload
    out = tgen.run_unit(prep["wire"], list(seeds),
                        draws=_jax_draws(seeds, B, HW[0] * HW[1], S),
                        sps=torch.from_numpy(sps_j))
    assert (out["cluster"].numpy() == np.asarray(cluster)).mean() >= 0.99
    assert (out["road"].numpy() == np.asarray(road)).mean() >= 0.99
    np.testing.assert_array_equal(out["ok"].numpy(), np.asarray(ok))
    np.testing.assert_array_equal(out["res"].n_iter.numpy(),
                                  np.asarray(res.n_iter))


def test_process_dataset_quality_close_to_jax(scenes, jgen, state_dict):
    """Felzenszwalb, the port's own draws: records carry each image's
    superpixel count, and road IoU is within 0.1 of JAX's."""
    ds = scenes[0]
    jrec = jgen.process_dataset(ds, save=False)
    tgen = tlg.SpalignLabelGenerator(_cfgs("felzenszwalb")[1],
                                     state_dict=state_dict, device="cpu")
    trec = tgen.process_dataset(ds, save=False)
    assert len(trec) == len(jrec) == 2 * B
    assert [r["n_superpixels"] for r in trec] == [r["n_superpixels"]
                                                  for r in jrec]
    j_iou = np.mean([r["road_iou"] for r in jrec])
    t_iou = np.mean([r["road_iou"] for r in trec])
    assert abs(j_iou - t_iou) < 0.1, (j_iou, t_iou)
    assert {"time_superpixel", "time_upload", "time_device_program",
            "time_score"} <= set(trec[0])


def test_overlaps_felzenszwalb_matches_jax(scenes, jgen, state_dict):
    """The overlaps mode's reference default (felzenszwalb of the full
    frames): JAX's uniforms injected, masks agree on >= 0.99."""
    _, imgs, full = scenes
    imgs, full = imgs[:B], full[:B]
    sp = dict(method="felzenszwalb", max_superpixels=256)
    jg = jdirect.make_label_generator(JaxLabelGenConfig(
        mode="overlaps", superpixel=JaxSuperpixelConfig(**sp), **COMMON),
        variables=jgen.variables)
    jprep = jg._host_prepare(imgs, full, JaxStageTimer())
    seeds = np.asarray([7], np.uint32)
    road, _, _ = jg._fused_program()(jprep["imgs_dev"], seeds, np.int32(4))
    want, _ = jdirect._refine_packed_program(256, 1)(
        road, jprep["full_sps"], 0.01)
    tg = tdirect.make_label_generator(tcfg.LabelGenConfig(
        mode="overlaps", superpixel=tcfg.SuperpixelConfig(**sp), **COMMON),
        state_dict=state_dict, device="cpu")
    tprep = tg._host_prepare(imgs, full)
    np.testing.assert_array_equal(tprep["full_sps"].numpy(),
                                  np.asarray(jprep["full_sps"]))
    np.testing.assert_array_equal(tprep["counts"], jprep["counts"])
    uniforms = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.key(7), (B * 14 * 14,))))[None]
    out = tg.run_unit(tprep["wire"], list(seeds), uniforms=uniforms)
    got, _ = tdirect.refine_and_pack(out["road"], tprep["full_sps"], 0.01,
                                     256)
    assert got.shape == (B, *FULL)
    assert (got.numpy() == np.asarray(want)).mean() >= 0.99


WIRE_CASES = {
    "parity_yuv420": dict(upload_format="yuv420",
                          kmeans=("KMeansConfig", dict(init="reference"))),
    "parity_direct_yuv420": dict(mode="direct", upload_format="yuv420",
                                 kmeans=("KMeansConfig",
                                         dict(init="reference"))),
    "felzenszwalb_yuv420": dict(upload_format="yuv420"),
    "slic_connectivity_yuv420": dict(
        upload_format="yuv420",
        superpixel=("SuperpixelConfig", dict(method="slic"))),
    "odd_shape_yuv420": dict(upload_format="yuv420", resize_shape=(111, 112),
                             superpixel=("SuperpixelConfig", dict(
                                 method="slic",
                                 slic_enforce_connectivity=False))),
    "unknown_wire": dict(upload_format="png"),
}


def _build_cfg(package, change):
    kw = dict(COMMON)
    for key, value in change.items():
        if isinstance(value, tuple) and isinstance(value[0], str):
            value = getattr(package, value[0])(**value[1])
        kw[key] = value
    return package.LabelGenConfig(**kw)


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_wire_rules_raise_like_jax(case):
    import spalign_tpu.config as jax_config

    with pytest.raises(ValueError):
        jdirect.make_label_generator(_build_cfg(jax_config,
                                                WIRE_CASES[case]))
    with pytest.raises(ValueError):
        tdirect.make_label_generator(_build_cfg(tcfg, WIRE_CASES[case]),
                                     device="cpu")


def test_yuv420_runs_where_jax_runs():
    """Overlaps with felzenszwalb and the device SLIC frontend take the
    yuv420 wire; the parity mode pins float32 whatever model_dtype."""
    gen = tdirect.make_label_generator(tcfg.LabelGenConfig(
        mode="overlaps", upload_format="yuv420", batchsize=B,
        resize_shape=HW), device="cpu")
    assert isinstance(gen, tdirect.OverlapsLabelGenerator)
    gen = tlg.SpalignLabelGenerator(tcfg.LabelGenConfig(
        model_dtype="bfloat16", resize_shape=HW,
        kmeans=tcfg.KMeansConfig(init="reference")), device="cpu")
    assert next(gen.model.parameters()).dtype == torch.float32
