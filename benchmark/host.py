"""What the host's CPUs did over the window, for telling contention on the
host from the program's own time: the cores this process used and the
cores' mean clock (``/proc/cpuinfo``) and, where ``/proc/stat`` moves
(a sandbox may hold it still), the shares of all cores' time that was
busy, waiting on I/O and taken by the hypervisor (steal).  Printed on
standard error; empty where ``/proc`` is not there."""

from __future__ import annotations

import os
import time
from pathlib import Path


def sample() -> tuple[list[int], float, float] | None:
    try:
        fields = Path("/proc/stat").read_text().splitlines()[0].split()
    except OSError:
        return None
    return ([int(v) for v in fields[1:9]], time.process_time(),
            time.perf_counter())


def _mhz() -> float | None:
    try:
        vals = [float(line.split(":")[1])
                for line in Path("/proc/cpuinfo").read_text().splitlines()
                if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(vals) / len(vals) if vals else None


def describe(before, after) -> str:
    """One line over the span between two :func:`sample` calls."""
    if before is None or after is None:
        return ""
    d = [b - a for a, b in zip(before[0], after[0])]
    total = max(sum(d), 1)
    user, nice, system, idle, iowait, irq, softirq, steal = d
    wall = max(after[2] - before[2], 1e-9)
    mhz = _mhz()
    cores = (after[1] - before[1]) / wall
    out = f"host over the window: this process {cores:.3f} cores"
    if mhz:
        out += f"; clock {mhz:.0f} MHz"
    if sum(d) > 0:
        busy = (user + nice + system + irq + softirq) / total
        out += (f"; all {os.cpu_count()} cores: busy {busy:.4f}, iowait "
                f"{iowait / total:.4f}, steal {steal / total:.4f}")
    return out
