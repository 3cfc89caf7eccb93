"""The port's benchmark (spalign_tpu_torch/bench.py) against the JAX
package's bench.py at the repository root.

bench.py is read, not run here (its functions time JAX on a TPU): each
label mode's LabelGenConfig equals bench.py's ``_label_gen_cfg`` field by
field, and the train and relabel recipes, the metric names, units,
baselines, batch counts and the mode list equal the values in bench.py's
source.  Then every kind of mode runs on the CPU at a tiny size (the rows'
keys only: a CPU run's numbers are never a device metric), the checks
refuse wrong masks, and ``main()`` without CUDA exits non-zero with no
line.  The tests marked ``cuda`` run the default row and the overlaps_slic
row (the assignment kernel at K = 1,035) on the card."""

import ast
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from spalign_tpu_torch import bench as tbench
from spalign_tpu_torch.kernels import launch_counts
from spalign_tpu_torch.kernels import slic as tslic

ROOT = pathlib.Path(__file__).resolve().parent.parent
LABEL_MODES = ("slic", "slic_scored", "slic_d2", "slic_cc", "felzenszwalb",
               "direct", "overlaps", "overlaps_slic")
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jbench():
    """The root bench.py as a module (its top level imports only numpy)."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jsource():
    text = (ROOT / "bench.py").read_text()
    return text, ast.parse(text)


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _literal_assigns(fn) -> dict:
    """name -> value of the literal assignments in a function body
    (tuples unpacked)."""
    out = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name):
            out[target.id] = value
        elif isinstance(target, ast.Tuple):
            out.update({t.id: v for t, v in zip(target.elts, value)})
    return out


def _call(fn, name):
    return next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", getattr(n.func, "attr", None))
                == name)


@pytest.mark.parametrize("mode", LABEL_MODES)
def test_label_configs_equal_bench_py(jbench, mode):
    want = dataclasses.asdict(jbench._label_gen_cfg(mode))
    got = dataclasses.asdict(tbench.label_gen_cfg(mode))
    assert set(got) == set(want)
    for field in want:
        assert got[field] == want[field], field


def test_train_and_relabel_recipes_equal_bench_py(jsource):
    _, tree = jsource
    call = _call(_function(tree, "bench_train"), "TrainConfig")
    want = {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg != "compute_dtype"}
    for dtype in ("float32", "bfloat16"):
        cfg = tbench.train_cfg(dtype)
        assert {k: getattr(cfg, k) for k in want} == want
        assert cfg.compute_dtype == dtype
    fn = _function(tree, "bench_relabel")
    consts = _literal_assigns(fn)
    rc = tbench.RELABEL
    assert (rc["n_images"], rc["batch"]) == (consts["n_imgs"],
                                             consts["batch"])
    assert rc["input_shape"] == (consts["h"], consts["w"])
    assert rc["eval_shape"] == consts["eval_hw"]
    assert tbench.RELABEL_STORES == consts["variants"]
    call = _call(fn, "relabel_dataset")
    kw = {k.arg: ast.unparse(k.value) for k in call.keywords}
    assert kw["score_dtype"] == "np.float16"
    assert rc["score_dtype"] is np.float16
    assert kw["soft_label"] == "True"


def test_constants_metrics_and_modes_equal_bench_py(jbench, jsource):
    text, tree = jsource
    for name in ("REFERENCE_IMAGES_PER_SEC",
                 "REFERENCE_OVERLAPS_IMAGES_PER_SEC",
                 "REFERENCE_DIRECT_IMAGES_PER_SEC",
                 "REFERENCE_TRAIN_MS_PER_STEP", "BATCH", "GROUPS",
                 "N_BATCHES_TIMED", "FULL_SHAPE"):
        assert getattr(tbench, name) == getattr(jbench, name), name
    # relabel's baseline is a literal in bench.py
    assert 'rate["eval"] / 3.0' in text
    assert tbench.baseline("relabel") == 3.0
    # the metric names as bench.py forms them
    assert '("label_gen_images_per_sec" if mode == "slic"' in text
    assert 'else f"label_gen_{mode}_images_per_sec")' in text
    assert '"metric": "relabel_images_per_sec"' in text
    assert ('("segnet_train_ms_per_step" if compute_dtype == "float32"'
            in text)
    assert 'else f"segnet_train_{compute_dtype}_ms_per_step")' in text
    for mode in LABEL_MODES:
        want = ("label_gen_images_per_sec" if mode == "slic"
                else f"label_gen_{mode}_images_per_sec")
        assert tbench.metric_name(mode) == want
    assert tbench.metric_name("train_bf16") == \
        "segnet_train_bfloat16_ms_per_step"
    assert text.count('"unit": "img/s"') == 2
    assert '"unit": "ms/step"' in text
    # bench.py's base figures per mode (bench_label_gen's dict)
    assert tbench.baseline("overlaps_slic") == \
        jbench.REFERENCE_OVERLAPS_IMAGES_PER_SEC
    assert tbench.baseline("slic_d2") == jbench.REFERENCE_IMAGES_PER_SEC
    # the modes of --mode all, in order, and bench.py's --mode choices
    main = _function(tree, "main")
    lists = [ast.literal_eval(n) for n in ast.walk(main)
             if isinstance(n, ast.List) and all(
                 isinstance(e, ast.Constant) for e in n.elts)]
    assert list(tbench.MODES) in lists
    assert set(tbench.MODES) | {"all"} in [set(x) for x in lists]
    # bench.py's batches and repetitions of each label mode
    assert tbench._timed_counts("overlaps") == (2, 1)
    assert tbench._timed_counts("slic") == (3 * jbench.GROUPS, 5)
    assert tbench._timed_counts("overlaps_slic") == (4, 3)
    assert tbench._timed_counts("direct") == (jbench.N_BATCHES_TIMED, 5)


ROW_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.mark.parametrize("mode,full,resize", [
    ("slic", (64, 128), (56, 56)),
    ("slic_scored", (64, 128), (56, 56)),
    ("slic_cc", (64, 128), (56, 56)),
    ("direct", (64, 128), (56, 56)),
    ("overlaps_slic", (128, 256), (56, 56)),  # K = 1,035 at 64x128
])
def test_bench_label_gen_runs_on_the_cpu(mode, full, resize):
    before = launch_counts()
    row = tbench.bench_label_gen(mode, reps=1, device="cpu", n_batches=2,
                                 batch=2, full_shape=full,
                                 resize_shape=resize)
    assert set(row) == ROW_KEYS
    assert row["metric"] == tbench.metric_name(mode)
    assert row["unit"] == "img/s"
    assert row["value"] > 0 and math.isfinite(row["vs_baseline"])
    assert launch_counts() == before  # the CPU runs the plain versions
    if mode == "overlaps_slic":
        sp = tbench.label_gen_cfg(mode).superpixel
        assert tslic.slic_grid_size(full[0] // 2, full[1] // 2,
                                    sp.n_slic_segments) == 1035


# ways a unit's masks can land other than bit-packed uint8 of its shape
WRONG_PACKS = {
    "unpacked": lambda pack, road: road.to(torch.uint8),
    "not uint8": lambda pack, road: pack(road).to(torch.int16),
    "a row short": lambda pack, road: pack(road)[:, 1:],
}


@pytest.mark.parametrize("wrong", sorted(WRONG_PACKS))
def test_bench_checks_refuse_wrong_masks(monkeypatch, wrong):
    from spalign_tpu_torch.pipeline import direct

    pack = direct.pack_mask_bits
    monkeypatch.setattr(direct, "pack_mask_bits",
                        lambda road: WRONG_PACKS[wrong](pack, road))
    with pytest.raises(tbench.BenchCheckError, match="masks landed"):
        tbench.bench_label_gen("direct", reps=1, device="cpu", n_batches=1,
                               batch=2, full_shape=(64, 128),
                               resize_shape=(56, 56))


def test_bench_train_and_relabel_run_on_the_cpu():
    for dtype in ("float32", "bfloat16"):
        row = tbench.bench_train(compute_dtype=dtype, reps=1, device="cpu",
                                 steps=2, input_shape=(64, 128))
        assert set(row) == ROW_KEYS and row["unit"] == "ms/step"
        assert row["metric"] == tbench.metric_name(
            "train" if dtype == "float32" else "train_bf16")
        assert row["value"] > 0
    row = tbench.bench_relabel(reps=1, device="cpu", n_images=4, batch=2,
                               input_shape=(64, 128), eval_shape=(128, 256))
    assert set(row) == ROW_KEYS | {"network_store_value"}
    assert row["metric"] == "relabel_images_per_sec"
    assert row["unit"] == "img/s" and row["network_store_value"] > 0


def test_main_without_cuda_exits_nonzero_and_prints_no_line(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main(["--mode", "all"]) != 0
    assert capsys.readouterr().out == ""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "spalign_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


# ---- on the card (marker: cuda) ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (marker: cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_default_row_on_the_card(cuda, capsys, monkeypatch):
    """``main()`` at its default: one line, bench.py's keys plus the
    scored rate and the card's name and power limit."""
    # one unit of 5 groups a pass, one repetition
    monkeypatch.setattr(tbench, "_timed_counts",
                        lambda mode: (tbench.GROUPS, 1))
    assert tbench.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == "label_gen_images_per_sec"
    assert row["unit"] == "img/s" and row["value"] > 0
    assert {"vs_baseline", "scored_value", "scored_unit",
            "scored_vs_baseline", "device", "power_limit_w"} <= set(row)
    assert row["device"] == torch.cuda.get_device_name(0)
    assert row["power_limit_w"] > 0


@pytest.mark.cuda
def test_overlaps_slic_row_launches_the_assignment_kernel(cuda):
    """overlaps_slic on the card: 5 sums-only launches and 1 labelled
    launch of the assignment kernel a batch at K = 1,035."""
    before = launch_counts()
    row = tbench.bench_label_gen("overlaps_slic", reps=1, n_batches=1)
    after = launch_counts()
    assert row["metric"] == "label_gen_overlaps_slic_images_per_sec"
    # the warm-up and the timed pass: 2 batches
    assert after["slic_assign_sums"] - before["slic_assign_sums"] == 2 * 5
    assert after["slic_assign"] - before["slic_assign"] == 2 * 6
