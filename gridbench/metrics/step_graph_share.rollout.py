"""Share of the process's ``BatchedEnv`` steps that replayed a CUDA graph,
in percent: ``STEP_GRAPH_REPLAYS`` over itself plus ``STEP_EAGER_CALLS``
(``envs/batched.py``'s counters, a graph's eager warm-up step included).
None where the port has no such counters."""


def read(ctx):
    from gym_anm_tpu_torch.envs import batched

    replays = getattr(batched, "STEP_GRAPH_REPLAYS", None)
    eager = getattr(batched, "STEP_EAGER_CALLS", None)
    if replays is None or eager is None or not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
