"""dispatch_ms.train: the host time a training step spends issuing its
work, in ms: the sum over the program's ``step.sample`` (the cached step's
frontier sampling), ``step.forward``, ``step.backward`` and
``step.optimizer`` spans of each one's mean host time (one of each a
step; a step without sampling has no ``step.sample``).  Spans are stored
only while the slice is profiled; a program without them gives nothing."""

SPANS = ("step.sample", "step.forward", "step.backward", "step.optimizer")


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    try:
        from graphsage_torch.utils.obs import records
    except ImportError:
        return None
    ms = {name: [] for name in SPANS}
    for s in records()["spans"]:
        if s["name"] in ms:
            ms[s["name"]].append(s["host_ms"])
    means = [sum(v) / len(v) for v in ms.values() if v]
    return sum(means) if means else None
