"""The benchmark's general part: it finds a cell's configuration, traffic
mix, limits and per-layer readers by the names in ``BENCHMARK.json``, runs
the cell's driver, and assembles the result line.

A cell is driven by the ``kind`` of its traffic file: ``drivers/<kind>.py``
holds a ``Cell`` class with ``setup()``, ``window(seconds, trace)``,
``end_to_end()``, ``layer_run()`` and ``check(limits, readings)``.
Everything else a cell needs is data: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<workload>.json``; each per-layer
metric is ``metrics/<name>.py`` with a ``read(run)`` that returns a number
or None (nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that may not be loaded in a run's process, and
# the program's own benchmark module, which the harness does not use
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "spalign_tpu")
FORBIDDEN_MODULES = ("spalign_tpu_torch.bench",)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return load_json(path)


def cell_spec(bench: dict, workload: str) -> dict:
    """The workload's entry, its configuration entry and the data files
    (configuration, traffic, limits) it names."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"cell": cell, "config": load_json(REPO / conf["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json")}


def metric_names(bench: dict, workload: str, section: str) -> list:
    """(name, unit) of the ``section`` metrics the workload reports."""
    return [(m["name"], m["unit"]) for m in bench[section]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seeds(seed: int, n: int) -> list:
    """``n`` independent 31-bit seeds derived from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(
        n, dtype=np.uint32) >> 1]


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in sys.modules}
    found = sorted(t for t in tops if t in FORBIDDEN_TOP)
    return found + [m for m in FORBIDDEN_MODULES if m in sys.modules]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out[0] if out else "nvidia-smi printed nothing"


def build_libraries(names) -> float:
    """Build the program's native libraries the cell runs (the builds of
    the first run in a checkout); seconds taken."""
    t0 = time.perf_counter()
    for name in names:
        lib = getattr(importlib.import_module(name), "LIBRARY", None)
        if lib is not None:
            lib.get()
    return time.perf_counter() - t0


def device_block(device, chips: int, peak_bytes: int) -> dict:
    import torch

    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def log(msg: str):
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", spec: dict = None, bench: dict = None,
             readings: bool = False, hooks=None) -> dict:
    """One run of a cell.  Returns the result line's object; with
    ``readings`` also the control readings under ``"readings"`` (for
    setting limits; the benchmark's own runs do not compute them).
    ``spec`` replaces the cell's data files (the tests run tiny sizes on
    the CPU); ``hooks(cell)`` may break the timed path (the tests)."""
    import torch

    bench = benchmark() if bench is None else bench
    spec = cell_spec(bench, workload) if spec is None else spec
    cell_entry, traffic = spec["cell"], spec["traffic"]
    dev = torch.device(device)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['kind']}")
    cell = driver.Cell(spec["config"], traffic, seed, dev,
                       chips=cell_entry["chips"])
    try:
        t0 = time.perf_counter()
        parts = cell.setup()
        setup_s = time.perf_counter() - t0
        log("setup_s " + repr(setup_s) + " = " + ", ".join(
            f"{k} {v!r}" for k, v in parts.items()))
        if hooks is not None:
            hooks(cell)
        window_s = min(seconds, traffic["trace_seconds"]) if trace else seconds
        # what set-up made stays out of the collector's passes
        gc.collect()
        gc.freeze()
        tr = cell.window(window_s, trace)
        peak = cell.memory_peak()
        leaked = forbidden_modules()
        if leaked:
            raise SystemExit(f"forbidden modules loaded: {leaked}")
        checks, failed, reads = cell.check(spec["limits"], readings)
        correct = failed == 0 and all(c["value"] <= c["limit"]
                                      for c in checks.values())
        out = {"correct": bool(correct), "attempted": int(cell.attempted()),
               "failed": int(failed)}
        if trace:
            run = cell.layer_run(tr)
            metrics = {}
            for name, unit in metric_names(bench, workload, "per_layer"):
                v = reader(name)(run)
                if v is not None and math.isfinite(v):
                    metrics[name] = {"value": float(v), "unit": unit}
            out["metrics"] = metrics
        else:
            e2e = dict(cell.end_to_end(), setup_s=setup_s)
            out["metrics"] = {name: {"value": float(e2e[name]), "unit": unit}
                              for name, unit in metric_names(bench, workload,
                                                             "end_to_end")}
        out["device"] = device_block(dev, cell_entry["chips"], peak)
        if trace:
            log(f"trace: {len(tr['ops'])} device operations read in "
                f"{tr['read_s']!r} s")
            out["device"]["busy_s"] = float(tr["busy_s"])
            out["device"]["window_s"] = float(tr["window_s"])
            out["breakdown"] = {"device_ops": tr["device_ops"],
                                "idle_gaps": tr["idle_gaps"]}
        if readings:
            out["readings"] = reads
        out["checks"] = checks
    finally:
        cell.close()
    return out
