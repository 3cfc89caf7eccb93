"""Rules of the port: spalign_tpu_torch/ and chip_smoke.py import no JAX,
flax, cv2, PIL, matplotlib, spalign_tpu or the root bench.py, and the entry points default
to CUDA and raise without it instead of falling back to the CPU."""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

from spalign_tpu_torch import bench as port_bench
from spalign_tpu_torch import config
from spalign_tpu_torch import entry as port_entry
from spalign_tpu_torch.cli import bottom_half as cli_bottom_half
from spalign_tpu_torch.cli import convert_model as cli_convert_model
from spalign_tpu_torch.cli import demo_video as cli_demo_video
from spalign_tpu_torch.cli import label_gen as cli_label_gen
from spalign_tpu_torch.cli import relabel as cli_relabel
from spalign_tpu_torch.cli import rounds as cli_rounds
from spalign_tpu_torch.cli import sweep as cli_sweep
from spalign_tpu_torch.cli import train as cli_train
from spalign_tpu_torch.kernels.slic import slic
from spalign_tpu_torch.models.drn import DRN_FACTORIES
from spalign_tpu_torch.models.segnet import build_segnet
from spalign_tpu_torch.pipeline.direct import (DirectLabelGenerator,
                                               OverlapsLabelGenerator,
                                               make_label_generator)
from spalign_tpu_torch.pipeline.label_gen import SpalignLabelGenerator
from spalign_tpu_torch.pipeline.superpixels import compute_superpixels
from spalign_tpu_torch.selftrain import RoundsDriver, relabel_dataset
from spalign_tpu_torch.train.evaluator import Evaluator
from spalign_tpu_torch.train.trainer import Trainer, build_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "matplotlib",
             "spalign_tpu", "bench")
PORT_FILES = sorted((ROOT / "spalign_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_sees_the_whole_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"spalign_tpu_torch/kernels/slic_fused.py",
            "spalign_tpu_torch/kernels/slic_assign.py",
            "spalign_tpu_torch/kernels/pooling.py",
            "spalign_tpu_torch/pipeline/label_gen.py",
            "spalign_tpu_torch/pipeline/direct.py",
            "spalign_tpu_torch/pipeline/superpixels.py",
            "spalign_tpu_torch/native.py",
            "spalign_tpu_torch/ops/parity.py",
            "spalign_tpu_torch/eval/results.py",
            "spalign_tpu_torch/cli/common.py",
            "spalign_tpu_torch/cli/label_gen.py",
            "spalign_tpu_torch/cli/train.py",
            "spalign_tpu_torch/data/png.py",
            "spalign_tpu_torch/data/cityscapes.py",
            "spalign_tpu_torch/train/trainer.py",
            "spalign_tpu_torch/parallel/dist.py",
            "spalign_tpu_torch/selftrain/relabel.py",
            "spalign_tpu_torch/selftrain/rounds.py",
            "spalign_tpu_torch/cli/relabel.py",
            "spalign_tpu_torch/cli/rounds.py",
            "spalign_tpu_torch/cli/sweep.py",
            "spalign_tpu_torch/cli/make_zips.py",
            "spalign_tpu_torch/cli/bottom_half.py",
            "spalign_tpu_torch/cli/mean_result.py",
            "spalign_tpu_torch/cli/make_table.py",
            "spalign_tpu_torch/cli/convert_model.py",
            "spalign_tpu_torch/cli/demo_video.py",
            "spalign_tpu_torch/eval/tables.py",
            "spalign_tpu_torch/utils/video.py",
            "spalign_tpu_torch/utils/viz.py",
            "spalign_tpu_torch/utils/timers.py",
            "spalign_tpu_torch/entry.py",
            "spalign_tpu_torch/kernels/experimental/ccl.py",
            "spalign_tpu_torch/bench.py",
            "chip_smoke.py"} <= names


_RELABEL_ARGS = ["--param_dir", "p", "--img_zip_fn", "i.zip",
                 "--label_zip_fn", "l.zip", "--out_dir", "o"]
_DEMO_ARGS = ["--param_dir", "p", "--frames_dir", "f", "--out_dir", "o"]


def _default(fn, name="device"):
    return inspect.signature(fn).parameters[name].default


def test_entry_points_default_to_cuda():
    for gen in (SpalignLabelGenerator, DirectLabelGenerator,
                OverlapsLabelGenerator):
        assert _default(gen.__init__) == "cuda"
    assert _default(make_label_generator) == "cuda"
    assert _default(compute_superpixels) == "cuda"
    assert cli_label_gen.get_args(["--synthetic", "1"]).device == "cuda"
    assert cli_train.get_args([]).device == "cuda"
    assert cli_rounds.get_args([]).device == "cuda"
    assert cli_relabel.get_args(_RELABEL_ARGS).device == "cuda"
    assert cli_demo_video.get_args(_DEMO_ARGS).device == "cuda"
    assert _default(relabel_dataset) == "cuda"
    assert _default(RoundsDriver.__init__) == "cuda"
    assert _default(slic) == "cuda"
    for factory in DRN_FACTORIES.values():
        assert _default(factory) == "cuda"
    for entry in (Trainer.__init__, Evaluator.__init__, build_segnet,
                  build_model, port_entry.entry,
                  port_entry.dryrun_multichip, port_bench.bench_label_gen,
                  port_bench.bench_relabel, port_bench.bench_train,
                  port_bench.run_mode):
        assert _default(entry) == "cuda"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sp = config.SuperpixelConfig(method="slic",
                                 slic_enforce_connectivity=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpalignLabelGenerator(config.LabelGenConfig(superpixel=sp))
    for mode in ("direct", "overlaps"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_label_generator(config.LabelGenConfig(mode=mode,
                                                       superpixel=sp))
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_superpixels(np.zeros((1, 8, 8, 3), np.uint8), sp)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_label_gen.main(["--mode", "direct", "--synthetic", "1",
                            "--synthetic_shape", "16", "16",
                            "--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        slic(torch.zeros((1, 8, 8, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        DRN_FACTORIES["drn_c_26"]()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(config.TrainConfig(result_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main(["--result_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(None, list, (8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_segnet("basic")
    with pytest.raises(RuntimeError, match="CUDA"):
        relabel_dataset(None, None, [], str(tmp_path / "r.0.zip"))
    with pytest.raises(RuntimeError, match="CUDA"):
        RoundsDriver(config.RoundsConfig(), config.TrainConfig(),
                     lambda *a: None, lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_relabel.main(_RELABEL_ARGS)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_rounds.main(["--result_base_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_sweep.main(["--grid", "fig7", "--synthetic", "1",
                        "--synthetic_shape", "16", "16",
                        "--sweep_out", str(tmp_path / "s.csv")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_demo_video.main(_DEMO_ARGS)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_bottom_half.main(["--synthetic", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.dryrun_multichip(1)
    pth = str(tmp_path / "drn.pth")
    torch.save(DRN_FACTORIES["drn_c_26"](device="cpu").state_dict(), pth)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_convert_model.main([pth, str(tmp_path / "out.pth"), "--check"])
