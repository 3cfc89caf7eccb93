"""The reader of ``drn_folded_pct.label`` on tiny CPU runs of the label
cell: a traced run reports it as 100 (outside the parity mode the folded
DRN serves every image, on the CPU too), an untraced run leaves it out,
and a program without the counters, or without ``drn.folded_images``,
gives None."""

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny
from spalign_tpu_torch.utils import timers

SEED = 2 ** 31 + 4127
WORKLOAD = "spalign-slic.mem"
NAME = "drn_folded_pct.label"


@pytest.mark.parametrize("trace", [True, False])
def test_label_run_reports_the_folded_share_only_when_traced(trace):
    torch.set_num_threads(4)
    timers.reset()
    out = harness.run_cell(WORKLOAD, SEED, 1.5, trace, device="cpu",
                           spec=tiny.spec(WORKLOAD))
    assert out["correct"] is True
    if trace:
        assert out["metrics"][NAME]["value"] == 100
    else:
        assert NAME not in out["metrics"]


@pytest.mark.parametrize("counts,want", [
    ({}, None), ({"drn.images": 300}, None),
    ({"drn.images": 300, "drn.folded_images": 300}, 100.0),
    ({"drn.images": 300, "drn.folded_images": 150}, 50.0)],
    ids=["none", "parent", "all", "half"])
def test_folded_share_from_the_counters(monkeypatch, counts, want):
    monkeypatch.setattr(timers, "counts", lambda traced=None: counts)
    assert harness.reader(NAME)(None) == want
