"""The reader of ``unit_graph_pct.label`` on tiny CPU runs of the label
cell: a traced run reports it as 0 (CPU tensors run every unit's program
eagerly, no unit is a graph replay), an untraced run leaves it out, and a
program without the counters gives None."""

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny
from spalign_tpu_torch.utils import timers

SEED = 2 ** 31 + 4111
WORKLOAD = "spalign-slic.mem"
NAME = "unit_graph_pct.label"


@pytest.mark.parametrize("trace", [True, False])
def test_label_run_reports_the_unit_graph_share_only_when_traced(trace):
    torch.set_num_threads(4)
    timers.reset()
    out = harness.run_cell(WORKLOAD, SEED, 1.5, trace, device="cpu",
                           spec=tiny.spec(WORKLOAD))
    assert out["correct"] is True
    if trace:
        assert out["metrics"][NAME]["value"] == 0
    else:
        assert NAME not in out["metrics"]


def test_no_counters_no_unit_graph_share(monkeypatch):
    monkeypatch.setattr(timers, "counts", lambda traced=None: {})
    assert harness.reader(NAME)(None) is None
