"""Host/device overlap: bounded background-thread batch prefetch.

Port of ``graphsage_tpu/utils/prefetch.py``.  ``Prefetcher`` runs the
host-side batch builder on a worker thread feeding a bounded queue, so
batch ``i+1`` (pair sampling, C++ compact build, label/mask assembly, all
numpy) is built while the card runs step ``i``.

Determinism: the producer runs the same sequential loop body the serial path
would, consuming the trainer's ``np.random.RandomState`` in the same order,
so prefetched and serial epochs are bit-identical.  The RandomState must
not be touched by the consumer while an epoch's producer is live.  Host to
device copies stay on the consumer thread; the producer is numpy only.

Tracing (``utils/obs.py``): the producer runs under the consumer's carried
span state, refreshed at each batch taken; each take is a ``prefetch.wait``
span and counts ``prefetch.gets``, and ``prefetch.starved`` when the queue
was empty.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, TypeVar

from graphsage_torch.utils import obs

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher:
    """Iterate ``producer()`` on a daemon thread through a bounded queue.

    ``depth`` bounds host memory (at most ``depth`` built-but-unconsumed
    batches) and keeps the producer from racing arbitrarily far ahead of
    the device.  Exceptions raised inside the producer are re-raised at
    the consuming ``__next__`` call with their original traceback.
    """

    def __init__(self, producer: Callable[[], Iterator[T]], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._carried = obs.Carry()
        self._thread = threading.Thread(
            target=self._run, args=(producer,), daemon=True,
            name="gs-batch-prefetch")
        self._thread.start()

    def _run(self, producer: Callable[[], Iterator[T]]) -> None:
        with self._carried:
            self._produce(producer)

    def _produce(self, producer: Callable[[], Iterator[T]]) -> None:
        try:
            for item in producer():
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> T:
        self._carried.refresh()
        starved = self._q.empty()
        with obs.span("prefetch.wait"):
            item = self._q.get()
        if item is _SENTINEL:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        obs.count("prefetch.gets")
        if starved:
            obs.count("prefetch.starved")
        return item

    def close(self, timeout: float = 60.0) -> None:
        """Abort the producer (used on error paths mid-epoch).

        Blocks until the producer thread actually exits (draining the
        queue each round so a producer parked on a full-queue ``put`` can
        reach its stop check): the producer shares the caller's
        ``np.random.RandomState``, so returning while it still runs would
        let it keep drawing from the stream the caller goes on to use.  A
        producer that outlives ``timeout`` (a truly wedged native call) is
        abandoned LOUDLY so the caller knows its RNG state is no longer
        trustworthy."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.5)
            if time.monotonic() > deadline:
                import sys
                print("prefetch.close: producer thread did not exit "
                      f"within {timeout}s — abandoning it; shared RNG "
                      "state may still be mutated in the background",
                      file=sys.stderr)
                return


def prefetch(producer: Callable[[], Iterator[T]], depth: int = 2,
             enabled: bool = True) -> Iterator[T]:
    """Iterator over ``producer()`` items, optionally built ahead on a
    worker thread.  ``enabled=False`` returns the plain iterator (serial
    reference path for parity tests)."""
    if not enabled:
        return iter(producer())
    return Prefetcher(producer, depth=depth)
