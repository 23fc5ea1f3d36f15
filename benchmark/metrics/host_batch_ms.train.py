"""host_batch_ms.train: the mean host time of one step's host batch in the
compact trainer, from the program's ``train.host_batch`` span on the
prefetch thread (the pair extension, the C++ frontiers, labels and row
mask), in ms.  Spans are stored only while the slice is profiled; a program
without them gives nothing."""

SPAN = "train.host_batch"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    try:
        from graphsage_torch.utils.obs import records
    except ImportError:
        return None
    ms = [s["host_ms"] for s in records()["spans"] if s["name"] == SPAN]
    return sum(ms) / len(ms) if ms else None
