"""Device operations (kernels, copies, fills) a step, from the profiled
stretch's trace: a rollout segment's fresh-state pool is counted in its
steps, and a vector-env step's fresh states and host copies in it."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_device_ops:
        return None
    return t.n_device_ops / ctx.counters["traced"]["steps"]
