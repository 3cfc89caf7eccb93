"""The harness end to end on the CPU at tiny sizes (its look for a card
skipped): the result line's schema, the reference agreeing with the
program, a run whose timed path is broken coming out not correct, and a
cell added by files alone."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

SEED = 2 ** 31 + 977
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(workload, trace=False, hooks=None, spec=None, bench=None,
        readings=False):
    torch.set_num_threads(4)
    return harness.run_cell(workload, SEED, 1.5, trace, device="cpu",
                            spec=spec or tiny.spec(workload), bench=bench,
                            hooks=hooks, readings=readings)


@pytest.mark.parametrize("workload,trace", [
    ("spalign-slic.mem", False), ("spalign-slic.mem", True),
    ("segnet-basic.files", False), ("segnet-basic.files", True)])
def test_schema_and_agreement(workload, trace):
    out = run(workload, trace)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in out) == trace
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        bench = harness.benchmark()
        want = {n for n, _ in harness.metric_names(bench, workload,
                                                   "end_to_end")}
        assert set(out["metrics"]) == want and "setup_s" in want
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


def _flip_masks(cell):
    finish = cell.gen.finish_batch

    def broken(prepared, handles, timers):
        res = finish(prepared, handles, timers)
        handles["host"]["road_packed"][0] ^= 0xFF
        return res

    cell.gen.finish_batch = broken


def _half_features(cell):
    features = cell.gen.features

    def broken(images):
        out = features(images)
        out[out.shape[0] // 2:] = 0
        return out

    cell.gen.features = broken


def _unchanged_step(cell):
    trainer = cell.trainer
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    step = trainer.train_step

    def broken(images, labels):
        out = step(images, labels)
        trainer.model.load_state_dict(state)
        return out

    trainer.train_step = broken


def _half_batch(cell):
    step = cell.trainer.train_step

    def broken(images, labels):
        n = images.shape[0] // 2
        return step(images[:n], labels[:n])

    cell.trainer.train_step = broken


def _altered_answer(cell):
    step = cell.trainer.train_step
    model = cell.trainer.model

    def broken(images, labels):
        out = step(images, labels)
        with torch.no_grad():
            model.conv_classifier.bias.add_(1e-2)
        return out

    cell.trainer.train_step = broken


@pytest.mark.parametrize("workload,fault", [
    ("spalign-slic.mem", _flip_masks), ("spalign-slic.mem", _half_features),
    ("segnet-basic.files", _unchanged_step),
    ("segnet-basic.files", _half_batch),
    ("segnet-basic.files", _altered_answer)])
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    # the faults act from the first step on: the train cell's checked
    # steps run in set-up, so the fault goes in before them
    if workload.startswith("segnet"):
        from perfbench.drivers import train

        first = train.Cell._first_steps

        def faulty_first(self, opt):
            fault(self)
            return first(self, opt)

        monkeypatch.setattr(train.Cell, "_first_steps", faulty_first)
        out = run(workload)
    else:
        out = run(workload, hooks=fault)
    assert out["correct"] is False


def test_controls_read_above_the_limits():
    """The controls the limits are set against, at a tiny size: the fp8
    DRN fails the feature limit; half the batch fails the train limits
    (TF32 does not exist on the CPU: the card's test reads it)."""
    label = run("spalign-slic.mem", readings=True)
    lim = harness.cell_spec(harness.benchmark(), "spalign-slic.mem")[
        "limits"]
    assert label["readings"]["feat_rel"] > lim["feat_rel"]
    train = run("segnet-basic.files", readings=True)
    lim = harness.cell_spec(harness.benchmark(), "segnet-basic.files")[
        "limits"]
    half = train["readings"]["half_batch"]
    assert any(half[k] > lim[k] for k in lim)


def test_a_cell_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, limits file and per-layer reader,
    found by the names a new BENCHMARK.json entry gives them."""
    here = harness.HERE
    base = tiny.spec("spalign-slic.mem")
    files = {here / "configs" / "zz-added.json": base["config"],
             here / "traffic" / "zz-added-mix.json": base["traffic"],
             here / "limits" / "zz-added.cell.json": base["limits"]}
    reader = here / "metrics" / "zz_added_images.py"
    bench = harness.benchmark()
    bench["configs"].append({"name": "zz-added", "source": "x",
                             "file": "perfbench/configs/zz-added.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "zz-added.cell", "config": "zz-added",
                               "traffic": "zz-added-mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "zz_added_images", "unit": "img",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "label_images_per_s",
                               "workloads": ["zz-added.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("label_images_per_s", "label_unit_p95_ms"):
            m["workloads"].append("zz-added.cell")
    try:
        for path, data in files.items():
            path.write_text(json.dumps(data))
        reader.write_text("def read(run):\n    return float(run.images)\n")
        spec = harness.cell_spec(bench, "zz-added.cell")
        assert spec["traffic"] == base["traffic"]
        out = run("zz-added.cell", spec=spec, bench=bench)
        assert out["correct"] and "label_images_per_s" in out["metrics"]
        out = run("zz-added.cell", trace=True, spec=spec, bench=bench)
        assert out["metrics"]["zz_added_images"]["value"] > 0
    finally:
        for path in [*files, reader]:
            path.unlink(missing_ok=True)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"),
                        "--workload", "spalign-slic.mem", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_data_parallel_agrees_and_fails_without_the_exchange(monkeypatch):
    """Four gloo ranks on the CPU: the reference agrees with the program;
    with the gradient all-reduce left out on every rank, not correct."""
    from perfbench.drivers import train
    from perfbench.tests import dp_faults

    bench, name, spec = tiny.dp_bench_and_spec(4)
    out = run(name, spec=spec, bench=bench)
    assert out["correct"] is True and out["device"]["count"] == 4
    assert set(out["metrics"]) == {"train_images_per_s.dp4", "setup_s"}
    traced = run(name, trace=True, spec=spec, bench=bench)
    assert {"loader_wait_ms.dp4", "mfu.dp4"} <= set(traced["metrics"])
    monkeypatch.setattr(train.Cell, "worker_hook",
                        "perfbench.tests.dp_faults:skip_exchange")
    from spalign_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_average", Trainer._average)
    dp_faults.skip_exchange()
    out = run(name, spec=spec, bench=bench)
    assert out["correct"] is False
