"""Host milliseconds a ``step_fn`` call takes to enqueue a step (no
synchronisation), over every step of the window: the benchmark's span around
each call into ``envs/batched.py``."""


def read(ctx):
    c = ctx.counters
    if not c.get("step_fn_calls"):
        return None
    return 1e3 * c["step_fn_s"] / c["step_fn_calls"]
