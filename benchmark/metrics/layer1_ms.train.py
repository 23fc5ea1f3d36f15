"""layer1_ms.train: the mean device time of a training step's layer 1 in
the cached step, in ms: the program's ``step.layer1`` span (the branch
``layer1_full_table`` takes: the full-table transform and its gather, or
the gathers and the transform of the frontier's rows), timed by a pair of
CUDA events in the stream.  Spans are stored only while the slice is
profiled; a program without them gives nothing."""

SPAN = "step.layer1"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    try:
        from graphsage_torch.utils.obs import records
    except ImportError:
        return None
    ms = [s["device_ms"] for s in records()["spans"]
          if s["name"] == SPAN and s["device_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
