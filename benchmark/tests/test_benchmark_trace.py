"""The reduction of a profile to busy time, kernels, operations and named
idle gaps, on a made-up event list."""

import types

import torch

from benchmark import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def evt(name, start, end, device=CPU, thread=1):
    return types.SimpleNamespace(
        name=name, device_type=device, thread=thread,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_parse_busy_gaps_and_names():
    events = [
        evt("bench:slice", 0, 1000),
        evt("bench:epoch", 10, 990),
        evt("aten::to", 100, 400),
        evt("cudaMemcpyAsync", 110, 390),
        evt("bench:epoch", 10, 990, device=CUDA),   # mirrored span: skipped
        evt("kernel_a", 0, 100, device=CUDA),
        evt("kernel_a", 50, 90, device=CUDA),       # overlaps the first
        evt("Memcpy HtoD", 400, 500, device=CUDA),
        evt("kernel_b", 900, 1200, device=CUDA),    # clipped to the slice
    ]
    r = trace.parse(events, ticks=2, wall_s=9.0)
    assert r.window_s == 1000 / 1e6
    assert abs(r.busy_s - 300 / 1e6) < 1e-12
    assert r.kernels == 3
    assert set(r.device_ops) == {"kernel_a", "kernel_b", "Memcpy HtoD"}
    assert abs(r.kernel_s("kernel_a") - 140 / 1e6) < 1e-12
    names = dict((round(s * 1e6), n) for n, s in r.idle_gaps)
    assert names[300] == "epoch > aten::to > cudaMemcpyAsync"
    assert names[400] == "epoch"
    b = r.breakdown()
    assert [n for n, _ in b["device_ops"]][0] == "kernel_a"


def test_tracer_is_inert_when_off():
    t = trace.Tracer(False, 3, torch.device("cpu"))
    t.warm()
    t.begin()
    with t.span("x"), t.timed("y"):
        t.tick()
    assert t.finish() is None
