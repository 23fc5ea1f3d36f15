"""Observability and fault handling: a jsonl metrics sink, the
deadline-guarded device fetch, the first-step watchdog and the test wedge.

Port of ``graphsage_tpu/utils/obs.py``:

- ``MetricsLogger`` appends one JSON object per event (epoch losses, F1s)
  to a file;
- ``fetch_with_deadline`` brings a device value to the host with a hard
  wall-clock deadline, so a kernel that hangs on the card surfaces as
  :class:`FetchDeadlineError` in seconds instead of a silent hang;
- ``collective_watchdog`` dumps diagnostics if a guarded block (the first
  training step, which also loads the kernels) has not finished in time;
- ``maybe_inject_test_wedge`` is the fault-injection seam of the
  auto-resume supervisor's tests (``graphsage_torch.supervise``);
- ``profile`` writes a ``torch.profiler`` trace of a block, and
  ``enable_nan_checks`` turns autograd's NaN checks on and off;
- ``span`` and ``count`` mark the phases of training and serving (host
  batch, prefetch wait, the step's parts, layer 1, the serving transforms,
  GraphSAGE-pool's pool transforms: ``serve.pool`` and ``step.pool``, and
  the counter ``pool.transform_rows``)
  while a ``torch.profiler`` records, on the profile's timeline and in a
  bounded in-memory store that ``records`` reads; ``Carry`` hands the
  on/off state to a worker thread.

The CLI exits with code 17 on :class:`FetchDeadlineError`, and the
supervisor relaunches it with ``--resume``.  In place of the JAX module's
mesh dump, ``collective_watchdog`` reports the ``torch.distributed``
group.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time

import torch


class MetricsLogger:
    def __init__(self, path: str | None = None):
        self.path = path
        self._t0 = time.time()

    def log(self, event: str, **fields) -> dict:
        """Append one record (a few per epoch, so the file is opened for
        each) and return it; without a path, only return it."""
        rec = {"t": round(time.time() - self._t0, 3), "event": event,
               **fields}
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


@contextlib.contextmanager
def profile(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (the host's ops,
    and the card's kernels where there is a card) and write the trace
    into ``log_dir`` as Chrome trace JSON when the block ends.  Yields the
    trace file's path.  The JAX module writes a ``jax.profiler`` trace
    directory for TensorBoard instead."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


# ------------------------------------------------------------------ spans
#
# A span is on exactly while a torch.profiler records on the calling thread
# (or, on a worker thread, while its owner's did when it last looked: see
# ``Carry``).  Off, ``span`` returns one shared no-op object after one check.
# On, the span is an event ``gs:<name>`` of the profile and a record in the
# store.  The event is a FUNCTION-scope record (``_RecordFunctionFast``, as
# an operator's), not a user annotation (``record_function``), which the
# CUDA profiler mirrors onto the device's timeline as if it were device
# work.  Stamps are ``time.time_ns()``: the profile's timeline is on the
# Unix clock (its ``trace_start_ns`` plus each event's microseconds).

SPAN_PREFIX = "gs:"
SPANS_KEPT = 1 << 16          # the store's bound: the oldest drop first

_profiling = torch._C._autograd._profiler_enabled


class _Local(threading.local):
    carried = None        # the Carry this worker thread runs under
    stack = None          # the open spans, innermost last


_local = _Local()


class _Store:
    """The spans and counters of the process (like the profiler, one a
    process)."""

    def __init__(self):
        self.spans: collections.deque = collections.deque(maxlen=SPANS_KEPT)
        self.counts: collections.Counter = collections.Counter()
        self.lock = threading.Lock()


_STORE = _Store()


class _Off:
    """The span of a thread that no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "event", "cuda", "thread", "parent",
                 "start", "end", "device_ms")

    def __init__(self, name: str, device, counts: dict, profiled: bool):
        self.name = name
        self.counts = counts
        # the profiler cannot see a worker thread: its spans go to the
        # store only
        self.event = (torch._C._profiler._RecordFunctionFast(
            SPAN_PREFIX + name) if profiled else None)
        self.cuda = None
        if (device is not None and torch.device(device).type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            self.cuda = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
        self.device_ms = None

    def note(self, **counts) -> None:
        """Add counts known only inside the block."""
        self.counts.update(counts)

    def __enter__(self):
        stack = _local.stack
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.start = time.time_ns()
        if self.event is not None:
            self.event.__enter__()
        if self.cuda is not None:
            self.cuda[0].record()
        return self

    def __exit__(self, *exc):
        if self.cuda is not None:
            self.cuda[1].record()
        if self.event is not None:
            self.event.__exit__(*exc)
        self.end = time.time_ns()
        _local.stack.pop()
        self.event = None
        self.thread = threading.current_thread().name
        with _STORE.lock:
            _STORE.spans.append(self)
        return False


class Carry:
    """The on/off state of the thread that made it, handed to a worker
    thread: spans and counts on a thread inside ``with carried:`` are on
    while ``carried.on``.  The owner calls ``refresh()`` to hand on its
    state again (``utils/prefetch.py`` does at each batch it takes)."""
    __slots__ = ("on",)

    def __init__(self):
        self.on = _profiling()

    def refresh(self) -> None:
        self.on = _profiling()

    def __enter__(self):
        _local.carried = self
        return self

    def __exit__(self, *exc):
        _local.carried = None
        return False


def span(name: str, device=None, **counts):
    """A context manager marking one phase ``name`` of the program's work,
    with ``counts`` (numbers that describe it; ``note`` adds more inside
    the block).  Off (no profiler recording on this thread), the shared
    no-op.  On, an event ``gs:<name>`` of the profile and, at the block's
    end, a record in the store: name, thread name, parent span on this
    thread, start and end (``time.time_ns``), counts.  ``device``: where
    the block's work runs; a CUDA device also times the block on its
    current stream with a pair of CUDA events (not while the stream is
    capturing), resolved only by ``records``."""
    if _profiling():
        return _Span(name, device, counts, True)
    carried = _local.carried
    if carried is None or not carried.on:
        return _OFF
    return _Span(name, device, counts, False)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the store's counter ``name`` when spans are on."""
    carried = _local.carried
    if _profiling() or (carried is not None and carried.on):
        with _STORE.lock:
            _STORE.counts[name] += n


def records(clear: bool = False) -> dict:
    """The store: {"spans": [{"name", "thread", "parent", "start_ns",
    "end_ns", "host_ms", "device_ms", "counts"}, ...] (oldest first,
    ``device_ms`` None for a span without CUDA events), "counts": {name:
    n}}.  Spans timed on the device are resolved here, after one
    synchronisation.  ``clear`` empties the store."""
    with _STORE.lock:
        spans = list(_STORE.spans)
        counts = dict(_STORE.counts)
        if clear:
            _STORE.spans.clear()
            _STORE.counts.clear()
    pending = [s for s in spans if s.cuda is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s.cuda[0].elapsed_time(s.cuda[1])
            s.cuda = None
    return {"spans": [{"name": s.name, "thread": s.thread,
                       "parent": s.parent, "start_ns": s.start,
                       "end_ns": s.end, "host_ms": (s.end - s.start) / 1e6,
                       "device_ms": s.device_ms, "counts": s.counts}
                      for s in spans],
            "counts": counts}


def enable_nan_checks(enable: bool = True) -> None:
    """Turn autograd's anomaly mode with NaN checks on or off
    (``torch.autograd.set_detect_anomaly(enable, check_nan=True)``), the
    port's ``jax_debug_nans``.  The coverage differs: JAX checks the
    output of every operation it runs, forward ones included; anomaly
    mode checks what each backward function returns, so it raises where
    a gradient first turns NaN (naming the forward op whose backward it
    is) and not where a forward value does, and it checks nothing that
    runs outside autograd (``torch.no_grad`` serving, the samplers)."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


class FetchDeadlineError(RuntimeError):
    """A device-to-host fetch exceeded its deadline (a hung kernel)."""


def maybe_inject_test_wedge(epoch: int) -> None:
    """Fault-injection seam for the supervisor's tests: when
    ``GS_TEST_WEDGE_SENTINEL`` names a path that does not exist yet and
    ``epoch >= 1`` (so at least one evaluation and checkpoint has passed),
    create the sentinel and raise the :class:`FetchDeadlineError` that a
    hung fetch raises, once per sentinel file, so the relaunched process
    trains through.  A no-op unless the variable is set."""
    sentinel = os.environ.get("GS_TEST_WEDGE_SENTINEL")
    if sentinel and epoch >= 1 and not os.path.exists(sentinel):
        open(sentinel, "w").close()
        raise FetchDeadlineError(
            "injected test wedge (GS_TEST_WEDGE_SENTINEL)")


def _device_lines() -> list[str]:
    """The cards and the memory the caching allocator holds on each (no
    call that waits for the device)."""
    if not torch.cuda.is_available():
        return ["  devices: cpu"]
    return [f"  device cuda:{i}: {torch.cuda.get_device_name(i)}, "
            f"{torch.cuda.memory_allocated(i) / 2**20:.1f} MiB allocated, "
            f"{torch.cuda.memory_reserved(i) / 2**20:.1f} MiB reserved"
            for i in range(torch.cuda.device_count())]


def fetch_with_deadline(value, label: str = "device fetch",
                        timeout_s: float | None = None, convert=float,
                        stream=None):
    """``convert`` of a device value on the host, within ``timeout_s``
    seconds (default 120, env ``GS_FETCH_TIMEOUT_S``), which is far above
    any healthy fetch (ms).

    For a CUDA tensor an event is recorded on the current stream (behind
    all the work queued there) and polled against the clock, so the host
    never blocks inside a CUDA call while the value is pending: a kernel
    that hangs raises :class:`FetchDeadlineError` here, after a diagnostic
    dump, and leaves no thread behind.  Nothing before the poll can block:
    no copy is queued and no pinned memory is allocated (allocating pinned
    memory waits for the device, a hung kernel included).  Once the event
    has passed, the value is copied on a stream of its own and ``convert``
    runs on the host copy.  Any other value is converted on a daemon
    worker thread, as in the JAX package, so a conversion that blocks is
    bounded too (the blocked thread is leaked: the only sane reaction to
    the error is to exit and resume).
    """
    if timeout_s is None:
        timeout_s = float(os.environ.get("GS_FETCH_TIMEOUT_S", "120"))
    deadline = time.monotonic() + timeout_s
    if isinstance(value, torch.Tensor) and value.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(value.device))
        pause = 5e-5
        while not done.query():
            left = deadline - time.monotonic()
            if left <= 0:
                _deadline_passed(label, timeout_s, stream)
            time.sleep(min(pause, left))
            pause = min(2 * pause, 5e-3)
        with torch.cuda.stream(torch.cuda.Stream(value.device)):
            return convert(value.cpu())

    box: dict = {}

    def work():
        try:
            box["value"] = convert(value)
        except BaseException as e:  # re-raised on the caller's thread
            box["err"] = e

    t = threading.Thread(target=work, daemon=True,
                         name=f"gs-fetch[{label}]")
    t.start()
    t.join(max(deadline - time.monotonic(), 0.0))
    if t.is_alive():
        _deadline_passed(label, timeout_s, stream)
    if "err" in box:
        raise box["err"]
    return box["value"]


def _deadline_passed(label: str, timeout_s: float, stream) -> None:
    out = stream if stream is not None else sys.stderr
    lines = [f"[fetch-deadline] {label!r} has not returned after "
             f"{timeout_s:g}s: a kernel has likely hung and wedged the "
             f"fetch.  Recovery: kill this process and restart (resume from "
             f"the last checkpoint)."]
    try:
        lines.extend(_device_lines())
    except Exception as e:  # the device may itself be in a bad state
        lines.append(f"  (device query failed: {e!r})")
    print("\n".join(lines), file=out, flush=True)
    raise FetchDeadlineError(
        f"{label} did not complete within {timeout_s:g}s")


def _group_lines(label: str, group) -> list[str]:
    """The process group's diagnostics (the JAX package's mesh dump): rank,
    world, backend, this rank's device and the first collective step."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return []
    dev = (f"cuda:{torch.cuda.current_device()}"
           if torch.cuda.is_available() else "cpu")
    return [f"  process group: rank {dist.get_rank(group)} of "
            f"{dist.get_world_size(group)}, backend "
            f"{dist.get_backend(group)}, device {dev}; first collective "
            f"step: {label}",
            "  check: every rank must reach this step; a peer that never "
            "does leaves this rank waiting in its first collective until "
            "the group's timeout (GS_DIST_TIMEOUT_S) raises."]


@contextlib.contextmanager
def collective_watchdog(label: str = "first step",
                        timeout_s: float | None = None, stream=None,
                        group=None):
    """Watchdog for a block that may hang with no error, such as the first
    training step (which also loads the kernels on the card) or the first
    collective step of a distributed trainer: if it has not finished after
    ``timeout_s`` (default 300 s, env ``GS_WATCHDOG_TIMEOUT_S``), a daemon
    timer dumps process and device diagnostics to stderr, and, where a
    ``torch.distributed`` group is formed, the group's (rank, world,
    backend, device, ``label``).  The block itself is never interrupted.

    Yields a dict with a ``fired`` flag.  Cheap enough to leave on: one
    timer started and cancelled."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("GS_WATCHDOG_TIMEOUT_S", "300"))
    out = stream if stream is not None else sys.stderr
    state = {"fired": False}

    def dump():
        state["fired"] = True
        lines = [f"[watchdog] {label!r} has not completed after "
                 f"{timeout_s:g}s.", f"  process {os.getpid()}"]
        try:
            lines.extend(_device_lines())
            lines.extend(_group_lines(label, group))
        except Exception as e:  # the device may itself be in a bad state
            lines.append(f"  (device query failed: {e!r})")
        lines.append(
            "  check: a cold kernel build takes seconds; a step that runs "
            "far longer has likely hung in a kernel (the deadline-guarded "
            "fetch that follows will end the process with code 17).")
        print("\n".join(lines), file=out, flush=True)

    timer = threading.Timer(timeout_s, dump)
    timer.daemon = True
    timer.start()
    try:
        yield state
    finally:
        timer.cancel()
