"""mfu.train: the training step's share of the card's peak for the
configuration's dtype: the algorithm's matmul FLOPs of the nodes trained
in the traced slice (``counts.train_flops_per_node``, whatever rows the
program transforms), over the slice's length, in percent."""

from benchmark.counts import PEAK_FLOPS


def read(ctx):
    t = ctx.trace
    if t.busy_s <= 0:
        return None
    flops = t.ticks * ctx.per_tick["nodes"] * ctx.counts["flops_per_node"]
    peak = PEAK_FLOPS[ctx.cell.config["model"]["compute_dtype"]]
    return 100.0 * flops / t.window_s / peak
