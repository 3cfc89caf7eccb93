"""The reader of ``kmeans_graph_pct.label`` on tiny CPU runs of the label
cell: a traced run reports it as a finite number (0: CPU tensors run the
k-means loop eagerly, no chunk is a graph replay), an untraced run leaves
it out, and a program without the tracer gives None."""

import math

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny
from spalign_tpu_torch.utils import timers

SEED = 2 ** 31 + 4099
WORKLOAD = "spalign-slic.mem"
NAME = "kmeans_graph_pct.label"


@pytest.mark.parametrize("trace", [True, False])
def test_label_run_reports_the_graph_share_only_when_traced(trace):
    torch.set_num_threads(4)
    timers.reset()
    out = harness.run_cell(WORKLOAD, SEED, 1.5, trace, device="cpu",
                           spec=tiny.spec(WORKLOAD))
    assert out["correct"] is True
    if trace:
        value = out["metrics"][NAME]["value"]
        assert math.isfinite(value) and value == 0
    else:
        assert NAME not in out["metrics"]


def test_no_tracer_no_graph_share(monkeypatch):
    monkeypatch.delattr(timers, "self_ns")
    assert harness.reader(NAME)(None) is None
