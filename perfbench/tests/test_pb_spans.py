"""The readers of the program's own spans and counters, on tiny CPU runs
of the harness: a traced run reports each of its cell's span metrics as
a finite number, an untraced run none of them, and a program without the
tracer gives none (the benchmark's files laid over an older program)."""

import math

import pytest
import torch

from perfbench import harness, spans
from perfbench.tests import tiny
from spalign_tpu_torch.utils import timers

SEED = 2 ** 31 + 4099
NEW = {"spalign-slic.mem": ["label_dispatch_ms", "label_device_wait_ms",
                            "label_unit_device_ms", "kmeans_sweeps.label"],
       "segnet-basic.files": ["h2d_wait_ms.train", "loader_ready.train",
                              "program_setup_s.train"]}


def run(workload, trace, spec=None, bench=None):
    torch.set_num_threads(4)
    timers.reset()
    return harness.run_cell(workload, SEED, 1.5, trace, device="cpu",
                            spec=spec or tiny.spec(workload), bench=bench)


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_run_reports_the_span_metrics(workload):
    out = run(workload, True)
    assert out["correct"] is True
    for name in NEW[workload]:
        assert math.isfinite(out["metrics"][name]["value"]), name
    m = {k: v["value"] for k, v in out["metrics"].items()}
    if workload == "spalign-slic.mem":
        assert m["label_unit_device_ms"] > 0 and m["label_dispatch_ms"] > 0
        # k-means runs at least one sweep a group, at most n_iter
        assert 1 <= m["kmeans_sweeps.label"] <= 1000
    else:
        assert m["loader_ready.train"] >= 0 and m["h2d_wait_ms.train"] > 0
        assert m["program_setup_s.train"] > 0


@pytest.mark.parametrize("workload", sorted(NEW))
def test_untraced_run_reports_none(workload):
    out = run(workload, False)
    assert not set(NEW[workload]) & set(out["metrics"])
    # what an untraced run leaves: nothing any reader takes but set-up
    assert spans.traced() == [] and spans.traced_counts() == {}


def test_no_tracer_no_metric(monkeypatch):
    """A program whose ``utils.timers`` has no tracer: every reader
    returns None and raises nothing."""
    monkeypatch.delattr(timers, "self_ns")
    for names in NEW.values():
        for name in names + ["grad_allreduce_ms.dp4"]:
            assert harness.reader(name)(None) is None


def test_grad_allreduce_on_two_gloo_ranks():
    bench, name, spec = tiny.dp_bench_and_spec(2)
    out = run(name, True, spec=spec, bench=bench)
    assert out["metrics"]["grad_allreduce_ms.dp4"]["value"] > 0
