"""prefetch_starved.train: the share of the batches the main thread took
from the prefetch queue when the queue was empty (it had to wait for the
prefetch thread), in percent: the program's ``prefetch.starved`` counter
over its ``prefetch.gets``.  Counters are kept only while the slice is
profiled; a program without them gives nothing."""

GETS, STARVED = "prefetch.gets", "prefetch.starved"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    try:
        from graphsage_torch.utils.obs import records
    except ImportError:
        return None
    counts = records()["counts"]
    gets = counts.get(GETS, 0)
    return 100.0 * counts.get(STARVED, 0) / gets if gets else None
