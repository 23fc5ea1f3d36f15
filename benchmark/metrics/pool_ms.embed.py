"""pool_ms.embed: the device time of a serving pass's pool transforms, in
ms: for each layer, the mean over its ``serve.pool`` spans that carry a
device time (GraphSAGE-pool's MLP over every row of the layer's input, one
``pretransform`` launch with the bias-and-relu epilogue a layer), timed by a
pair of CUDA events in the stream, summed over the layers.  Spans are stored
only while the slice is profiled; a program without them gives nothing."""

SPAN = "serve.pool"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    try:
        from graphsage_torch.utils.obs import records
    except ImportError:
        return None
    layers = {}
    for s in records()["spans"]:
        if s["name"] == SPAN and s["device_ms"] is not None:
            layers.setdefault(s["counts"].get("layer"), []).append(
                s["device_ms"])
    return sum(sum(v) / len(v) for v in layers.values()) if layers else None
