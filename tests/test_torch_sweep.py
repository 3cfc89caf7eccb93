"""Dynamic k, reconfigure and the sweep CLI of the port
(spalign_tpu_torch/pipeline/label_gen.py, pipeline/direct.py,
cli/sweep.py) against the JAX package's, on the CPU.

Tolerances: k-means assignments and cluster maps exact; the sweep CSV's
header, columns and rows exact but for the metrics, whose road IoU is
within 0.1 of JAX's per row (the two packages draw their random numbers
differently, ROADMAP queue 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spalign_tpu.cli import sweep as jsweep
from spalign_tpu.ops import kmeans as jkm
from spalign_tpu_torch import config as tcfg
from spalign_tpu_torch.cli import sweep
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.models.drn import DRN_FACTORIES
from spalign_tpu_torch.ops import kmeans as tkm
from spalign_tpu_torch.pipeline import label_gen as tlg
from spalign_tpu_torch.pipeline.direct import make_label_generator
from spalign_tpu_torch.pipeline.superpixels import compute_superpixels

torch.set_num_threads(2)

HW = (112, 112)
SLIC = tcfg.SuperpixelConfig(method="slic", n_slic_segments=40,
                             slic_iters=4, max_superpixels=128,
                             slic_enforce_connectivity=False)


def _cfg(**kw):
    base = dict(batchsize=3, resize_shape=HW, superpixel=SLIC,
                save_masks=False, model_dtype="float32")
    base.update(kw)
    return tcfg.LabelGenConfig(**base)


@pytest.fixture(scope="module")
def images():
    imgs, _ = SyntheticRoadScenes(n=3, full_shape=(256, 512),
                                  seed=9).resized_batch(range(3), HW)
    return imgs


@pytest.mark.parametrize("k", [2, 4, 6])
def test_dynamic_kmeans_equals_static_port(k):
    """JAX's weighted_kmeans_dynamic (k a runtime value under k_max = 6)
    against the port's weighted_kmeans at k, with JAX's seeding draws."""
    rng = np.random.RandomState(k)
    n, d = 150, 10
    centers = rng.randn(6, d) * 1.5
    lab = rng.randint(0, 6, n)
    X = (centers[lab] + rng.randn(n, d)).astype(np.float32)
    w = np.where(lab == 0, rng.uniform(0.5, 1, n),
                 rng.uniform(0, 0.5, n)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-9:] = False
    key = jax.random.key(k)
    want = jkm.weighted_kmeans_dynamic(jnp.asarray(X), jnp.asarray(w),
                                       jnp.asarray(valid), key, k, k_max=6)
    unif = np.array(jax.random.uniform(key, (n,)))
    got = tkm.weighted_kmeans(torch.from_numpy(X), torch.from_numpy(w),
                              torch.from_numpy(valid), k=k,
                              uniforms=torch.from_numpy(unif))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    assert int(got.n_iter) == int(want.n_iter)
    assert set(np.unique(got.assignment.numpy())) <= set(range(-1, k))


def test_dynamic_generator_equals_static(images):
    """One generator with dynamic_k = 6 after set_n_clusters(k) against a
    fresh static generator at k on the same seed stream (the twin of
    tests/test_pipeline_e2e.py's fused dynamic-k test)."""
    dyn = tlg.SpalignLabelGenerator(_cfg(), seed=5, device="cpu",
                                    dynamic_k=6)
    for k in (2, 4, 6):
        dyn.set_n_clusters(k)
        static = tlg.SpalignLabelGenerator(
            _cfg(kmeans=tcfg.KMeansConfig(n_clusters=k)), seed=5,
            device="cpu")
        dyn._seed_rng = np.random.RandomState(123)
        static._seed_rng = np.random.RandomState(123)
        _, c_dyn, d_dyn, _ = dyn.run_batch(images)
        _, c_sta, d_sta, _ = static.run_batch(images)
        np.testing.assert_array_equal(c_dyn.numpy(), c_sta.numpy())
        assert d_dyn["kmeans_iters"] == d_sta["kmeans_iters"]
        assert c_dyn.max() < k
    assert dyn.n_program_traces() == -1


def test_bounds_and_reconfigure(images):
    with pytest.raises(ValueError, match="dynamic_k bound 6"):
        tlg.SpalignLabelGenerator(
            _cfg(kmeans=tcfg.KMeansConfig(n_clusters=7)), device="cpu",
            dynamic_k=6)
    gen = make_label_generator(_cfg(model_dtype="bfloat16"), device="cpu",
                               dynamic_k=6)
    with pytest.raises(ValueError, match="n_clusters=7 > dynamic_k bound 6"):
        gen.set_n_clusters(7)
    assert gen.cfg.kmeans.n_clusters == 4
    stream = gen._seed_rng
    before = {k: v.clone() for k, v in gen.model.state_dict().items()}
    assert before["conv1.weight"].dtype == torch.bfloat16
    gen.reconfigure(dataclasses.replace(gen.cfg, model_dtype="float32"))
    assert gen.model.conv1.weight.dtype == torch.float32
    # the parity mode pins float32 too
    parity = dataclasses.replace(gen.cfg, model_dtype="bfloat16",
                                 kmeans=tcfg.KMeansConfig(init="reference"),
                                 superpixel=tcfg.SuperpixelConfig())
    gen.reconfigure(parity)
    assert gen.model.conv1.weight.dtype == torch.float32
    gen.reconfigure(dataclasses.replace(parity, kmeans=tcfg.KMeansConfig()))
    after = gen.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert gen._seed_rng is stream
    # superpixel geometry follows the config; yuv420 is refused on a host
    # engine, and a refused config changes nothing
    gen.reconfigure(_cfg(superpixel=dataclasses.replace(
        SLIC, n_slic_segments=20, slic_device_downscale=2)))
    assert gen._sp_hw == (56, 56) and gen._downscale == 2
    assert gen.num_segments < 40
    with pytest.raises(ValueError, match="yuv420"):
        gen.reconfigure(_cfg(superpixel=tcfg.SuperpixelConfig(),
                             upload_format="yuv420"))
    assert gen._downscale == 2
    # a felzenszwalb scale reaches the host engine
    for scale in (100.0, 800.0):
        sp = tcfg.SuperpixelConfig(felzenszwalb_scale=scale,
                                   max_superpixels=256)
        gen.reconfigure(_cfg(superpixel=sp))
        assert gen.num_segments == 256
        got = gen._host_prepare(images)["counts"]
        np.testing.assert_array_equal(
            got, compute_superpixels(images, sp, device="cpu")[1])
    assert got.max() < compute_superpixels(
        images, dataclasses.replace(sp, felzenszwalb_scale=100.0),
        device="cpu")[1].max()


@pytest.fixture(scope="module")
def shared_pth(tmp_path_factory):
    """One DRN for both packages: the port's seeded weights as a .pth."""
    path = str(tmp_path_factory.mktemp("drn") / "drn.pth")
    torch.save(DRN_FACTORIES["drn_c_26"](device="cpu").state_dict(), path)
    return path


def _read_csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [line.split(",") for line in lines[1:]]


@pytest.mark.parametrize("param,values", [
    ("kmeans.n_clusters", ["2", "3", "4"]),
    ("superpixel.felzenszwalb_scale", ["100", "300"])])
def test_sweep_cli_rows_like_jax(shared_pth, tmp_path, capsys, param,
                                 values):
    flags = ["--grid", "custom", "--param", param, "--values", *values,
             "--synthetic", "4", "--synthetic_shape", "128", "256",
             "--resize_shape", "112", "112", "--batchsize", "4",
             "--max_superpixels", "256", "--felzenszwalb_scale", "100",
             "--weights", shared_pth]
    sweep.main(flags + ["--device", "cpu", "--sweep_out",
                        str(tmp_path / "port.csv"),
                        "--out_dir", str(tmp_path / "port")])
    said = capsys.readouterr().out.splitlines()
    jsweep.main(flags + ["--sweep_out", str(tmp_path / "jax.csv"),
                         "--out_dir", str(tmp_path / "jax")])
    jsaid = capsys.readouterr().out.splitlines()
    head, rows = _read_csv(tmp_path / "port.csv")
    jhead, jrows = _read_csv(tmp_path / "jax.csv")
    assert head == jhead == (f"{param},road_mean_iou,precision,recall,n,"
                             "program_traces")
    assert len(rows) == len(jrows) == len(values)
    assert len(said) == len(jsaid) == len(values) + 1
    for row, jrow in zip(rows, jrows):
        assert row[0] == jrow[0]
        assert row[4] == jrow[4] == "4"
        assert row[5] == "-1"
        assert abs(float(row[1]) - float(jrow[1])) <= 0.1
