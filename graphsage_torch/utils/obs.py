"""Structured metrics: a jsonl sink.

Port of ``MetricsLogger`` from ``graphsage_tpu/utils/obs.py``: one JSON
object per event (epoch losses, F1s), appended to a file.  The JAX
package's deadline-guarded fetch, watchdog and test wedge guard its remote
TPU backend; their port is queued (ROADMAP A item 17).
"""

from __future__ import annotations

import json
import time


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
