"""The port's tracer (``spalign_tpu_torch/utils/timers.py``) and the spans
of the label loop, the train loop and set-up, on the CPU.

Span starts are held to the profiler's own events within 1 ms: both
stamp the epoch clock (``time.time_ns()``)."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spalign_tpu_torch.config import (KMeansConfig, LabelGenConfig,
                                      SuperpixelConfig, TrainConfig)
from spalign_tpu_torch.data.synthetic import SyntheticRoadScenes
from spalign_tpu_torch.pipeline.direct import make_label_generator
from spalign_tpu_torch.train.trainer import Trainer
from spalign_tpu_torch.utils import timers

torch.set_num_threads(2)

SLIC = SuperpixelConfig(method="slic", slic_enforce_connectivity=False,
                        n_slic_segments=20)
FELZ = SuperpixelConfig(felzenszwalb_scale=100)
# each mode's records' time keys, in order, as they were before the
# stages became spans
MODES = {
    "slic": (dict(superpixel=SLIC),
             ["time_load", "time_upload", "time_device_program",
              "time_kmeans", "time_score", "elapsed_time"]),
    "felzenszwalb": (dict(superpixel=FELZ, upload_format="rgb8"),
                     ["time_load", "time_upload", "time_superpixel",
                      "time_device_program", "time_kmeans", "time_score",
                      "elapsed_time"]),
    "parity": (dict(superpixel=FELZ, upload_format="rgb8",
                    kmeans=KMeansConfig(init="reference")),
               ["time_load", "time_upload", "time_superpixel",
                "time_features", "time_align", "time_prior",
                "time_device_program", "time_kmeans", "time_score",
                "elapsed_time"]),
    "direct": (dict(mode="direct", superpixel=SLIC),
               ["time_load", "time_upload", "time_device_program",
                "time_kmeans", "time_score", "elapsed_time"]),
    "overlaps": (dict(mode="overlaps", superpixel=SLIC),
                 ["time_load", "time_upload", "time_superpixel",
                  "time_device_program", "time_refine", "time_kmeans",
                  "time_score", "elapsed_time"]),
}


@pytest.fixture(autouse=True)
def fresh():
    timers.reset()
    yield
    timers.reset()


def named(name):
    return [s for s in timers.spans() if s.name == name]


def test_nesting_parents_ids_and_self_time():
    with timers.span("outer", unit=3) as outer:
        with timers.span("a") as a:
            with timers.span("leaf", step=7) as leaf:
                pass
        with timers.span("b", unit=None) as b:
            pass
    assert outer.parent is None
    assert a.parent == b.parent == outer.id and leaf.parent == a.id
    # a span takes its parent's ids and adds its own; None adds nothing
    assert outer.ids == a.ids == b.ids == {"unit": 3}
    assert leaf.ids == {"unit": 3, "step": 7}
    assert outer.start_ns <= a.start_ns <= leaf.start_ns <= leaf.end_ns \
        <= a.end_ns <= b.start_ns <= b.end_ns <= outer.end_ns
    assert not any(s.traced for s in (outer, a, leaf, b))
    assert {s.id for s in timers.spans()} == {outer.id, a.id, leaf.id, b.id}
    own = timers.self_ns(timers.spans())
    assert own[outer.id] == outer.ns - a.ns - b.ns
    assert own[a.id] == a.ns - leaf.ns and own[leaf.id] == leaf.ns
    # only the named descendants
    assert timers.self_ns(timers.spans(), within={"leaf"})[outer.id] == \
        outer.ns - leaf.ns


def test_self_time_by_hand():
    """Children that overlap each other count once, and only inside the
    parent."""
    def mk(i, start, end, parent=None):
        s = timers.Span("x", {})
        s.id, s.parent, s.start_ns, s.end_ns = i, parent, start, end
        return s

    sp = [mk(0, 0, 100), mk(1, 10, 40, 0), mk(2, 30, 60, 0),
          mk(3, 90, 130, 0), mk(4, 35, 50, 2)]
    assert timers.self_ns(sp) == {0: 100 - 50 - 10, 1: 30, 2: 30 - 15,
                                  3: 40, 4: 15}


def test_threads_keep_their_own_parents():
    out = {}

    def worker():
        with timers.span("worker") as w:
            out["w"] = w

    with timers.span("main") as m:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert out["w"].parent is None and out["w"].thread != m.thread


def test_the_buffer_keeps_the_newest():
    n = timers.BUFFER + 10
    for i in range(n):
        with timers.span("s", unit=i):
            pass
    got = timers.spans()
    assert len(got) == timers.BUFFER
    assert [s.ids["unit"] for s in got[:2]] == [10, 11]
    assert got[-1].ids["unit"] == n - 1


def test_counters_by_traced():
    timers.count("c")
    timers.count("c", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        timers.count("c", 2)
        timers.count("d")
    assert timers.counts() == {"c": 7, "d": 1}
    assert timers.counts(traced=True) == {"c": 2, "d": 1}
    assert timers.counts(traced=False) == {"c": 5}
    timers.reset()
    assert timers.counts() == {} and timers.spans() == []


def test_no_record_function_without_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with timers.span("quiet"):
        with timers.device_span("quiet.device", "cpu"):
            pass
    timer = timers.StageTimer("p.")
    with timer.stage("stage"):
        pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with timers.span("loud"):
            pass
    assert calls == ["loud"]
    assert [s.traced for s in timers.spans()] == [False, False, False, True]


def test_device_span_on_the_cpu_is_its_host_time():
    with timers.device_span("d", torch.device("cpu"), unit=1) as d:
        torch.ones(64).sum()
    assert d.device_ns == d.ns > 0 and d.ids == {"unit": 1}


def test_stage_timer_keeps_its_surface():
    t = timers.StageTimer("lbl.", unit=5)
    with t.stage("load"):
        pass
    with t.device_stage("device_program", "cpu"):
        pass
    with t.stage("load"):
        pass
    t.add("score", 0.25)
    times = t.finish()
    assert list(times) == ["time_load", "time_device_program",
                           "time_score", "elapsed_time"]
    load = named("lbl.load")
    assert len(load) == 2 and all(s.ids == {"unit": 5} for s in load)
    assert times["time_load"] == pytest.approx(
        sum(s.ns for s in load) / 1e9)
    dev = named("lbl.device_program")[0]
    assert times["time_device_program"] == dev.device_ns / 1e9
    assert times["time_score"] == 0.25


def _label_cfg(mode_kw):
    return LabelGenConfig(**{**dict(batchsize=2, resize_shape=(56, 56),
                                    save_masks=False, groups_per_dispatch=1),
                             **mode_kw})


@pytest.mark.parametrize("mode", sorted(MODES))
def test_label_loop_spans_and_record_keys(mode):
    kw, keys = MODES[mode]
    gen = make_label_generator(_label_cfg(kw), device="cpu")
    ds = SyntheticRoadScenes(6, (64, 128))
    timers.reset()
    recs = gen.process_dataset(ds)
    for r in recs:
        assert [k for k in r if k.startswith("time_")
                or k == "elapsed_time"] == keys
    n = 3  # units of 2 images
    retries = sum(r.get("retries", 0) for r in recs[::2])
    for name in ("label.dispatch", "label.land", "label.device_program",
                 "label.load", "label.upload", "label.records"):
        got = named(name)
        if name in ("label.dispatch", "label.land", "label.device_program"):
            assert len(got) == n + retries, name
        elif name != "label.upload":  # a host engine uploads its maps too
            assert len(got) == n, name
        assert sorted({s.ids["unit"] for s in got}) == list(range(n)), name
    assert len(named("label.pass")) == 1
    assert "unit" not in named("label.pass")[0].ids
    # the device program runs inside the dispatch of its unit
    by_id = {s.id: s for s in timers.spans()}
    for d in named("label.device_program"):
        assert by_id[d.parent].name == "label.dispatch"
        assert d.device_ns == d.ns
    for unit, r in enumerate(recs[::2]):
        spans = [d for d in named("label.device_program")
                 if d.ids["unit"] == unit]
        # the record's time is its unit's device spans' (every try's)
        assert r["time_device_program"] == pytest.approx(
            sum(d.device_ns for d in spans) / 1e9)
    if mode in ("slic", "felzenszwalb"):
        c = timers.counts()
        iters = [r["kmeans_iters"] for r in recs[::2]]
        assert c["kmeans.groups"] >= n and c["kmeans.sweeps"] >= sum(iters)
        for name in ("label.decode", "label.superpixels", "label.features",
                     "label.cluster", "label.pack"):
            assert len(named(name)) == n + retries, name


def test_label_spans_appear_among_the_profiler_events():
    gen = make_label_generator(_label_cfg(MODES["slic"][0]), device="cpu")
    ds = SyntheticRoadScenes(4, (64, 128))
    timers.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gen.process_dataset(ds)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e.start_ns())
    traced = [s for s in timers.spans() if s.traced]
    assert {s.name for s in traced} >= {
        "label.pass", "label.dispatch", "label.device_program",
        "label.land", "kmeans.check", "label.records"}
    for s in traced:
        assert s.name in events, s.name
        gap = min(abs(t - s.start_ns) for t in events[s.name])
        assert gap < 1_000_000, (s.name, gap)
    # the producer thread is not the profiler's: its spans are untraced
    assert {s.name for s in timers.spans() if not s.traced} == {
        "label.load", "label.upload"}


def test_train_step_and_setup_spans(tmp_path):
    cfg = TrainConfig(model="basic", batchsize=2, input_shape=(32, 64),
                      optimizer="Adam", loss="ce",
                      result_dir=str(tmp_path / "r"))
    timers.reset()
    trainer = Trainer(cfg, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(2):
        images = rng.rand(2, 32, 64, 3).astype(np.float32)
        labels = rng.randint(0, 2, (2, 32, 64)).astype(np.int32)
        trainer.train_step(*trainer.to_device(images, labels))
    assert [s.ids for s in named("train.h2d")] == [{"step": 0},
                                                   {"step": 1}]
    assert [s.ids for s in named("train.step")] == [{"step": 0},
                                                    {"step": 1}]
    setup = named("setup.trainer")
    assert len(setup) == 1
    # the trainer built its model inside its own set-up
    build = named("setup.build_segnet")
    assert len(build) == 1 and build[0].parent == setup[0].id
    assert named("train.grad_allreduce") == []  # one rank reduces nothing
