"""K1's share of its roofline in the profiled segments: the least time the
card could take for the power flows K1 solved (the larger of the operations
over the float32 peak and the bytes over the bandwidth, counted by the frozen
yardstick from the grid's shapes and the NR iterations the plain reference
needed for the window's inputs) over K1's device time in the trace."""

KERNEL = "tree_nr_kernel"


def read(ctx):
    t, y, g = ctx.trace, ctx.yardstick, ctx.grid
    if t is None or ctx.work.get("step_iters") is None:
        return None
    seconds, count = t.kernel_time(KERNEL)
    if not count:
        return None
    tr = ctx.counters["traced"]
    launches, steps = tr["launches"]["k1"], tr["steps"]
    n_branch = len(g.br_f)
    step_ops = y.power_flow_ops(g.n, n_branch, ctx.work["step_iters"])
    reset_ops = y.power_flow_ops(g.n, n_branch, ctx.work["reset_iters"] or ctx.work["step_iters"])
    ops = ctx.batch * (steps * step_ops + (launches - steps) * reset_ops)
    nbytes = ctx.batch * launches * y.power_flow_bytes(g.n)
    return y.roofline_pct(ops, nbytes, seconds)
