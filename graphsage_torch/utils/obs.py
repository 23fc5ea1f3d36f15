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
  auto-resume supervisor's tests (``graphsage_torch.supervise``).

The CLI exits with code 17 on :class:`FetchDeadlineError`, and the
supervisor relaunches it with ``--resume``.  The JAX module's mesh
diagnostics wait for the port's distributed pipelines (ROADMAP A item 16);
its ``profile`` and ``enable_nan_checks`` are reached by no entry point and
are not ported (item 17).
"""

from __future__ import annotations

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


@contextlib.contextmanager
def collective_watchdog(label: str = "first step",
                        timeout_s: float | None = None, stream=None):
    """Watchdog for a block that may hang with no error, such as the first
    training step (which also loads the kernels on the card): if it has
    not finished after ``timeout_s`` (default 300 s, env
    ``GS_WATCHDOG_TIMEOUT_S``), a daemon timer dumps process and device
    diagnostics to stderr.  The block itself is never interrupted.

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
