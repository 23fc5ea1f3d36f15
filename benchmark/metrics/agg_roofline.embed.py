"""agg_roofline.embed: the aggregation kernels' share of their roofline in
the serving passes: the least time their bytes need at 3.35 TB/s
(``counts.aggregate_bytes``: distinct rows read once, the index, the
degrees and the output once) over the device time the profiler gave the port's
``gather_reduce_kernel`` (``gather_mean`` and ``gather_max``), in
percent."""

KERNEL = "gather_reduce_kernel"


def read(ctx):
    t = ctx.trace
    spent = t.kernel_s(KERNEL)
    if spent <= 0:
        return None
    bound = t.ticks * ctx.per_tick["passes"] * ctx.counts["agg_bound_s_per_pass"]
    return 100.0 * bound / spent
