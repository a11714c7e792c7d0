"""Share of the process's ``LockstepEnv`` steps that replayed a CUDA graph,
in percent: ``LOCKSTEP_GRAPH_REPLAYS`` over itself plus
``LOCKSTEP_EAGER_CALLS`` (``envs/vector_core.py``'s counters, a graph's
eager warm-up step included).  None where the port has no such counters."""


def read(ctx):
    from gym_anm_tpu_torch.envs import vector_core

    replays = getattr(vector_core, "LOCKSTEP_GRAPH_REPLAYS", None)
    eager = getattr(vector_core, "LOCKSTEP_EAGER_CALLS", None)
    if replays is None or eager is None or not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
