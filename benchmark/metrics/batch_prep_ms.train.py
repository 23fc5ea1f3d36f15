"""batch_prep_ms.train: the mean host time of an epoch's batch preparation
in the cached trainer, from the program's ``train.batches`` span (the
permutation, the batches and labels, the visited count and their copies to
the card; one an epoch), in ms.  Spans are stored only while the slice is
profiled; a program without them gives nothing."""

SPAN = "train.batches"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    try:
        from graphsage_torch.utils.obs import records
    except ImportError:
        return None
    ms = [s["host_ms"] for s in records()["spans"] if s["name"] == SPAN]
    return sum(ms) / len(ms) if ms else None
