"""The port's examples (spalign_tpu_torch/examples/, the counterparts of
examples/quickstart.py and examples/explore.py) run small on the CPU:
quickstart as a user runs it (``python -m``, a cold interpreter),
explore in-process with its figure checked cell by cell against the
arrays it draws.  Their defaults are the JAX examples' sizes."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spalign_tpu_torch.data.png import decode_png
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.examples import explore, quickstart
from spalign_tpu_torch.utils.viz import MARGIN, TITLE_BAND, cell_origin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.mark.parametrize("module,want", [
    (quickstart, {"device": "cuda", "images": 8, "iterations": 20,
                  "workdir": None}),
    (explore, {"device": "cuda", "images": 4, "seed": 21,
               "out_dir": "results/explore"})], ids=["quickstart", "explore"])
def test_defaults_are_the_jax_examples(module, want):
    assert vars(module.parse_args([])) == want


def test_quickstart_runs_small(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "spalign_tpu_torch.examples.quickstart",
         "--device", "cpu", "--workdir", str(tmp_path), "--images", "4",
         "--iterations", "2"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    for head in ("pseudo-labels: road IoU", "self-training done:",
                 "round-2 labels:", "student after 2 rounds: road IoU"):
        assert any(line.startswith(head) for line in lines), head
    labels = sorted(os.listdir(tmp_path / "labels"))
    assert sum(f.endswith("_all_cluster.npy") for f in labels) == 4
    assert "result.json" in labels
    assert len(os.listdir(tmp_path / "imgs")) == 4
    final = tmp_path / "rounds" / "train_round2"
    assert (final / "iter-4_eval-train.0.zip").exists()
    assert (final / "iter-4_eval-train" / "result.json").exists()


def test_explore_figure(tmp_path):
    out = explore.main(["--device", "cpu", "--out_dir", str(tmp_path),
                        "--images", "2"])
    assert [os.path.basename(p) for p in out["paths"]] == [
        "stages_0.png", "stages_1.png"]
    assert len(out["road_iou"]) == 2 and all(
        np.isfinite(v) for v in out["road_iou"])
    assert out["kmeans_iters"] >= 1 and out["seconds"] > 0
    imgs, _ = SyntheticRoadScenes(n=2, full_shape=(512, 1024),
                                  seed=21).resized_batch(range(2),
                                                         (224, 224))
    hw = (448, 448)  # 224x224 stages repeated 2x2
    band = 7 * 2 + MARGIN  # the figure's title above the panel
    for b, path in enumerate(out["paths"]):
        with open(path, "rb") as f:
            fig = decode_png(f.read())
        assert fig.shape == (band + 2 * (TITLE_BAND + 448) + 3 * MARGIN,
                             3 * 448 + 4 * MARGIN, 3)

        def cell(i):
            y, x = cell_origin(i, 3, hw)
            return fig[band + y:band + y + 448, x:x + 448]

        np.testing.assert_array_equal(
            cell(0), imgs[b].repeat(2, 0).repeat(2, 1))
        # the boundaries are yellow over the input, everywhere else the
        # input itself
        over, inp = cell(1), cell(0)
        yellow = (over == explore.BOUNDARY).all(-1)
        assert 0 < yellow.mean() < 0.5
        np.testing.assert_array_equal(over[~yellow], inp[~yellow])
        # clusters in tab10, the road mask black and white
        clusters = cell(4).reshape(-1, 3)
        assert all((explore.TAB10 == c).all(-1).any()
                   for c in np.unique(clusters, axis=0))
        assert set(np.unique(cell(5))) <= {0, 255}
