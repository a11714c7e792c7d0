"""K3's share of its roofline in the profiled segments: the least time the
card could take for the whole transitions K3 computed (the larger of the
operations over the float32 peak and the bytes over the bandwidth, counted by
the frozen yardstick from the grid's shapes and the NR iterations the plain
reference needed for the window's inputs) over K3's device time in the
trace."""

KERNEL = "step_fused_kernel"


def read(ctx):
    t, y, g = ctx.trace, ctx.yardstick, ctx.grid
    if t is None or ctx.work.get("step_iters") is None:
        return None
    seconds, count = t.kernel_time(KERNEL)
    if not count:
        return None
    tr = ctx.counters["traced"]
    launches, steps = tr["launches"]["k3"], tr["steps"]
    shape = (g.n, len(g.br_f), len(g.loads), len(g.gens), len(g.des))
    step_ops = y.transition_ops(*shape, ctx.work["step_iters"])
    reset_ops = y.transition_ops(*shape, ctx.work["reset_iters"] or ctx.work["step_iters"])
    ops = ctx.batch * (steps * step_ops + (launches - steps) * reset_ops)
    nbytes = ctx.batch * launches * y.transition_bytes(*shape)
    return y.roofline_pct(ops, nbytes, seconds)
