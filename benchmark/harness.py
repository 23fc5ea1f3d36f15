"""One run of one cell: set-up, the measured window, the check.

Everything specific lives in files found by name:

- ``BENCHMARK.json`` (the repository root): the cell's configuration, traffic
  mix and chips, and the metrics it reports;
- ``benchmark/configs/<config>.json``: the model and the graph;
- ``benchmark/traffic/<traffic>.json``: the mix, whose ``kind`` names the
  driver module ``benchmark/kinds/<kind>.py``;
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric;
- ``benchmark/limits/<cell>.json``: the limit of each number that decides
  ``correct``.

A driver (``kinds/*.py``) is a class ``Driver(cell, seed, device, tracer)``
whose constructor makes the inputs, builds the program's object and warms
it up (recording what the check needs), with ``iteration()`` (one unit of
the window: an epoch or a pass), ``ticks_steps`` (whether it ticks the
tracer itself, a step at a time), ``per_tick`` and ``counts`` (for the
readers), ``attempted(units)``, ``end_to_end(units, window_s)``,
``release()`` (drop the program's state) and ``readings(controls)`` (the
reference comparison: the numbers, and with ``controls`` those of the
control and of the planted faults).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import compare, host
from benchmark.trace import Tracer

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``.  ``overrides`` ({"config":
    ..., "mix": ...}) changes sizes for the CPU tests."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = cells[name]
    cfg_file = next(c["file"] for c in spec["configs"]
                    if c["name"] == work["config"])
    config = json.loads((ROOT / cfg_file).read_text())
    mix = json.loads((BENCH / "traffic" / f"{work['traffic']}.json")
                     .read_text())
    overrides = overrides or {}
    config = _merge(config, overrides.get("config", {}))
    mix = _merge(mix, overrides.get("mix", {}))
    limits_file = BENCH / "limits" / f"{name}.json"
    limits = (json.loads(limits_file.read_text())
              if limits_file.exists() else {})
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, config, mix, work["chips"], e2e, per_layer, limits)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_class(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}").Driver


def reader(metric: str):
    return _load(BENCH / "metrics" / f"{metric}.py",
                 "benchmark_metric_" + metric.replace(".", "_")).read


@dataclasses.dataclass
class Ctx:
    """What a per-layer reader reads."""
    cell: Cell
    trace: object          # trace.TraceResult
    per_tick: dict         # work a tick of the slice stands for
    counts: dict           # the algorithm's operations and bytes


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    breakdown: dict | None
    checks: list
    controls: dict | None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, started: float,
        controls: bool = False) -> Outcome:
    """One run; ``started`` is the process's start on ``time.perf_counter``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracer = Tracer(trace, cell.mix.get("trace_ticks", 1), device)
    driver = driver_class(cell.mix["kind"])(cell, seed, device, tracer)
    tracer.warm()
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - started
    cpu0 = host.sample()
    units = 0
    while True:
        tracer.begin()
        driver.iteration()
        units += 1
        if not driver.ticks_steps:
            tracer.tick()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    usage = host.describe(cpu0, host.sample())
    if usage:
        print(usage, file=sys.stderr)
    result = tracer.finish()
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    attempted = driver.attempted(units)
    if trace:
        ctx = Ctx(cell, result, driver.per_tick, driver.counts)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(ctx) if result is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if result is not None:
            dev["busy_s"] = result.busy_s
            dev["window_s"] = result.window_s
    else:
        values = dict(driver.end_to_end(units, window_s), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings, extra = driver.readings(controls)
    checks = compare.checks(readings, cell.limits)
    return Outcome(correct=all(c.ok for c in checks), attempted=attempted,
                   failed=0, metrics=metrics, device=dev,
                   breakdown=(result.breakdown()
                              if trace and result is not None else None),
                   checks=checks, controls=extra)
