"""Tracing of a ``--trace 1`` run: the harness's own spans around calls into
the program, and ``torch.profiler`` over a bounded slice of the window.

A slice starts at the window's start (after a synchronisation) and ends
after ``limit`` ticks (epochs, steps or passes: the traffic kind says) or
at the window's end, with a synchronisation, so every device operation of
its work lies inside it.  A slice in which the profiler recorded no device
operation is thrown away and the next one traced, up to ``tries`` slices.
Nothing is written to disk.

``span`` marks a host span in the profile (``record_function``, named
``bench:<name>``); ``timed`` also times it on the device's clock with a
pair of CUDA events, over the whole window.  Both are no-ops in an
untraced run.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
import warnings
from collections import defaultdict

import torch

SPAN_PREFIX = "bench:"
SLICE = SPAN_PREFIX + "slice"
TOP = 10          # entries of each breakdown list


@dataclasses.dataclass
class TraceResult:
    ticks: int
    window_s: float
    busy_s: float
    kernels: int                      # device kernels (no copy or memset)
    device_ops: dict[str, float]      # device seconds by operation name
    idle_gaps: list[tuple[str, float]]
    spans_ms: dict[str, list[float]]  # ``timed`` spans, device clock

    def kernel_s(self, part: str) -> float:
        return sum(s for name, s in self.device_ops.items() if part in name)

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[name, s] for name, s in self.idle_gaps]}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _gap_name(at: float, host: list) -> str:
    """What the host's main thread was in at time ``at``: the innermost
    harness span, the outermost program operation inside it and the
    innermost call inside that (a CUDA runtime call, as a rule)."""
    span, ops = "window", []
    for evt in host:
        if evt.time_range.start > at:
            break
        if evt.time_range.end < at:
            continue
        if evt.name.startswith(SPAN_PREFIX):
            if evt.name != SLICE:
                span, ops = evt.name[len(SPAN_PREFIX):], []
        else:
            ops.append(evt.name)
    parts = [span] + ops[:1] + ops[-1:] if len(ops) > 1 else [span] + ops
    return " > ".join(parts)


def parse(events, ticks: int, wall_s: float) -> TraceResult:
    device, host, window = [], [], None
    for evt in events:
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            # the harness's spans are mirrored on the device's timeline
            if not evt.name.startswith(SPAN_PREFIX):
                device.append(evt)
        elif evt.name == SLICE:
            window = evt
    lo, hi = ((window.time_range.start, window.time_range.end)
              if window is not None else (float("-inf"), float("inf")))
    thread = window.thread if window is not None else None
    host = sorted((e for e in events
                   if e.device_type != torch.autograd.DeviceType.CUDA
                   and e.thread == thread and e.name != SLICE),
                  key=lambda e: e.time_range.start)
    spans, ops = [], defaultdict(float)
    kernels = 0
    for evt in device:
        start, end = max(evt.time_range.start, lo), min(evt.time_range.end, hi)
        if end <= start:
            continue
        spans.append((start, end))
        ops[evt.name] += (end - start) / 1e6
        kernels += not _is_copy(evt.name)
    busy = _merge(spans)
    window_s = (hi - lo) / 1e6 if window is not None else wall_s
    gaps = []
    if window is not None:
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    starts = [e.time_range.start for e in host]
    named = []
    for dur, start in gaps:
        # named by what the host was in halfway through the gap; only
        # events that began before then can hold it
        at = start + dur / 2
        cut = bisect.bisect_right(starts, at)
        named.append((_gap_name(at, host[:cut]), dur / 1e6))
    return TraceResult(ticks=ticks, window_s=window_s,
                       busy_s=sum(e - s for s, e in busy) / 1e6,
                       kernels=kernels, device_ops=dict(ops),
                       idle_gaps=named, spans_ms={})


class Tracer:
    def __init__(self, enabled: bool, limit: int, device: torch.device,
                 tries: int = 3):
        self.enabled = enabled
        self.limit = max(1, int(limit))
        self.cuda = device.type == "cuda"
        self.tries = tries
        self.done = not enabled
        self.result: TraceResult | None = None
        self._prof = None
        self._slice = None
        self._ticks = 0
        self._t0 = 0.0
        self._timed: dict[str, list] = defaultdict(list)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def timed(self, name: str):
        if not (self.enabled and self.cuda):
            with self.span(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with self.span(name):
            yield
        end.record()
        self._timed[name].append((start, end))

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's) takes seconds, which would fall into the slice."""
        if not self.enabled:
            return
        prof = self._profiler()
        prof.start()
        torch.ones(1, device="cuda" if self.cuda else "cpu").add_(1)
        self._sync()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prof.stop()

    def begin(self) -> None:
        if self.done or self._prof is not None:
            return
        self._sync()
        self._prof = self._profiler()
        self._prof.start()
        self._slice = torch.profiler.record_function(SLICE)
        self._slice.__enter__()
        self._ticks = 0
        self._t0 = time.perf_counter()

    def tick(self, n: int = 1) -> None:
        if self._prof is None:
            return
        self._ticks += n
        if self._ticks >= self.limit:
            self.end()

    def end(self) -> None:
        if self._prof is None:
            return
        self._sync()
        wall = time.perf_counter() - self._t0
        self._slice.__exit__(None, None, None)
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": one cycle
            warnings.simplefilter("ignore", UserWarning)
            self._prof.stop()
            events = self._prof.events()
        result = parse(events, self._ticks, wall)
        self._prof = self._slice = None
        self.tries -= 1
        if result.busy_s > 0 or self.tries <= 0 or not self.cuda:
            self.result = result
            self.done = True

    def finish(self) -> TraceResult | None:
        """End the slice if open; return the result with the ``timed``
        spans of the whole window."""
        self.end()
        self.done = True
        if self.result is not None:
            self._sync()
            self.result.spans_ms = {
                name: [s.elapsed_time(e) for s, e in pairs]
                for name, pairs in self._timed.items()}
        return self.result
