"""The share of the measured window's time in which no operation ran on the
device: one less the device's busy seconds a step (the union of the profiled
stretch's device intervals over its steps) over the window's seconds a step
(the measured window, unprofiled, over its steps).  The profiler slows the
host, so the profiled stretch's own length would overstate the idle share."""


def read(ctx):
    t, c = ctx.trace, ctx.counters
    if t is None or t.busy_s <= 0 or not c.get("steps") or not c.get("window_s"):
        return None
    busy_per_step = t.busy_s / c["traced"]["steps"]
    return 100.0 * (1.0 - busy_per_step / (c["window_s"] / c["steps"]))
