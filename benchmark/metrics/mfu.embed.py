"""mfu.embed: the serving passes' share of the card's peak for the
configuration's dtype: the algorithm's matmul FLOPs of the passes in the
traced slice (``counts.embed_flops_per_pass``) over its length, in
percent."""

from benchmark.counts import PEAK_FLOPS


def read(ctx):
    t = ctx.trace
    if t.busy_s <= 0:
        return None
    flops = t.ticks * ctx.per_tick["passes"] * ctx.counts["flops_per_pass"]
    peak = PEAK_FLOPS[ctx.cell.config["model"]["compute_dtype"]]
    return 100.0 * flops / t.window_s / peak
