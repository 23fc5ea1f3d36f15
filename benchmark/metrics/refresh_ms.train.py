"""refresh_ms.train: the mean device time of the leaf-cache refreshes of
the window (``CachedTrainer._refresh``), from the harness's span around
each call: a pair of CUDA events in the stream, on the device's clock."""


def read(ctx):
    spans = ctx.trace.spans_ms.get("refresh")
    return sum(spans) / len(spans) if spans else None
