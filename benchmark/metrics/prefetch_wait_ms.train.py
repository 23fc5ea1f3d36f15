"""prefetch_wait_ms.train: the main thread's mean wait a step for the
prefetch thread's batch, in ms: the host time of the program's
``prefetch.wait`` spans over its ``prefetch.gets`` counter (the batches
taken).  Spans and counters are stored only while the slice is profiled; a
program without them gives nothing."""

SPAN, GETS = "prefetch.wait", "prefetch.gets"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    try:
        from graphsage_torch.utils.obs import records
    except ImportError:
        return None
    rec = records()
    gets = rec["counts"].get(GETS, 0)
    ms = [s["host_ms"] for s in rec["spans"] if s["name"] == SPAN]
    return sum(ms) / gets if ms and gets else None
