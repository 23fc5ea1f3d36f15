"""pool_roofline.embed: the pool transforms' share of their roofline in the
serving passes, in percent: their least time (``pool.pass_counts``: per
layer the larger of the bytes at 3.35 TB/s, the input table read once, the
weight and the output written once, and the algorithm's 2 N K P operations
at the dtype's peak; the implementation's three-piece split is not
counted) over the device time the profiler gave the port's ``pretransform``
kernels in the traced slice.  None where the slice holds no such kernel."""

KERNEL = "pretransform"


def read(ctx):
    t = ctx.trace
    spent = t.kernel_s(KERNEL)
    bound = ctx.counts.get("pool_bound_s_per_pass")
    if spent <= 0 or bound is None:
        return None
    return 100.0 * t.ticks * ctx.per_tick["passes"] * bound / spent
