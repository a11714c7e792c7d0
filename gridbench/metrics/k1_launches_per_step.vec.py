"""Launches of the tree-NR kernel (K1, ``ops/tree_cuda.py``) a vector-env
step over the window, by the port's own launch counter: the step's solve and
the fresh states' solve."""


def read(ctx):
    c = ctx.counters
    if not c.get("steps"):
        return None
    return c["launches"]["k1"] / c["steps"]
