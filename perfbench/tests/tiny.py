"""Tiny specs of the benchmark's cells for runs on the CPU: the
configurations' widths as published, the traffic cut to a few small
scenes (the tests run the harness end to end without a card)."""

from __future__ import annotations

import copy

from perfbench import harness


def spec(workload: str) -> dict:
    bench = harness.benchmark()
    s = copy.deepcopy(harness.cell_spec(bench, workload))
    t = s["traffic"]
    t.update(scenes=4, frame_shape=[128, 256], trace_seconds=1,
             builds=[])
    if t["kind"] == "label":
        s["config"]["label_gen"].update(resize_shape=[64, 64], batchsize=2,
                                        groups_per_dispatch=2)
        t.update(pass_images=8, warm_images=4, check_from=1, check_units=1)
    else:
        s["config"].update(input_shape=[64, 128], batchsize=4)
        t.update(loader_workers=2, prefetch=2)
    return s


def dp_bench_and_spec(ranks: int = 4):
    """The benchmark, the data-parallel train cell's name, and its tiny
    spec over ``ranks`` CPU processes (gloo)."""
    bench = harness.benchmark()
    name = "segnet-basic.dp4"
    s = copy.deepcopy(harness.cell_spec(bench, name))
    s["traffic"].update(ranks=ranks, scenes=8, frame_shape=[128, 256],
                        trace_seconds=1, builds=[], loader_workers=2,
                        prefetch=2)
    s["config"].update(input_shape=[64, 128], batchsize=2 * ranks)
    return bench, name, s
