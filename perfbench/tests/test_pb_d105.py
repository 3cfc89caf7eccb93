"""The DRN-D-105 cell (``spalign-d105.mem``, driver ``label_drn_d``) on
tiny CPU runs of the harness, the network at its published widths and
depth: correct; a traced run reports the cell's per-layer metrics, and
the C-26 cell its backbone time, an untraced run none of them; and a
program whose ``label.features`` is a host span and which counts no
images (an older program) gives no backbone metric and raises nothing."""

import copy
import math

import pytest
import torch

from perfbench import harness, spans
from perfbench.tests import tiny
from spalign_tpu_torch.pipeline import label_gen
from spalign_tpu_torch.utils import timers

SEED = 2 ** 31 + 4099
WORKLOAD = "spalign-d105.mem"
NEW = ["backbone_device_ms.d105", "backbone_peak_pct.d105", "mfu.d105",
       "label_dispatch_ms.d105", "label_unit_device_ms.d105"]
BACKBONE = ["backbone_device_ms.d105", "backbone_peak_pct.d105"]


def d105_spec() -> dict:
    """The cell's data at ``tiny.spec``'s label sizes."""
    s = copy.deepcopy(harness.cell_spec(harness.benchmark(), WORKLOAD))
    s["traffic"].update(scenes=4, frame_shape=[128, 256], trace_seconds=1,
                        builds=[], pass_images=8, warm_images=4,
                        check_from=1, check_units=1)
    s["config"]["label_gen"].update(resize_shape=[64, 64], batchsize=2,
                                    groups_per_dispatch=2)
    return s


def run(workload, trace, spec):
    torch.set_num_threads(4)
    timers.reset()
    return harness.run_cell(workload, SEED, 1.5, trace, device="cpu",
                            spec=spec)


@pytest.mark.parametrize("trace", [True, False])
def test_cell_correct_and_its_metrics_only_when_traced(trace):
    out = run(WORKLOAD, trace, d105_spec())
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    if trace:
        for name in NEW:
            assert math.isfinite(m[name]), name
        assert m["backbone_device_ms.d105"] > 0
        assert m["backbone_device_ms.d105"] < m["label_unit_device_ms.d105"]
        assert 0 < m["backbone_peak_pct.d105"] <= 100
    else:
        assert not set(NEW) & set(m)
        assert set(m) == {"label_images_per_s", "label_unit_p95_ms",
                          "setup_s"}
        assert spans.traced() == []


def test_c26_cell_reports_its_backbone_time():
    out = run("spalign-slic.mem", True, tiny.spec("spalign-slic.mem"))
    value = out["metrics"]["backbone_device_ms.label"]["value"]
    assert out["correct"] is True and value > 0
    assert value < out["metrics"]["label_unit_device_ms"]["value"]


def test_host_span_program_gives_no_backbone_metric(monkeypatch):
    """The benchmark laid over a program that times ``label.features`` on
    the host and counts no images: the cell still runs, correct, and its
    line leaves the backbone metrics out."""
    monkeypatch.setattr(label_gen, "device_span",
                        lambda name, device, **ids: timers.span(name, **ids))
    monkeypatch.setattr(label_gen, "count", lambda name, n=1: None
                        if name == "drn.images" else timers.count(name, n))
    out = run(WORKLOAD, True, d105_spec())
    assert out["correct"] is True
    assert not set(BACKBONE) & set(out["metrics"])
    assert "mfu.d105" in out["metrics"]
    for name in BACKBONE + ["backbone_device_ms.label"]:
        assert harness.reader(name)(None) is None, name
