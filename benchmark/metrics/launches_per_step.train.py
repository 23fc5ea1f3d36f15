"""launches_per_step.train: device kernels the profiler recorded in the
traced slice (copies and memsets left out), per training step."""


def read(ctx):
    t = ctx.trace
    if t.busy_s <= 0:
        return None
    return t.kernels / (t.ticks * ctx.per_tick["steps"])
