"""Newton iterations a lane-solve of the whole-transition kernel (K3), over
the whole process: the port's device counter of K3's iterations
(``ops/step_cuda.py``, added in the kernel's epilogue, so the steps replayed
from a CUDA graph are counted too) over its host count of lane-solves.  None
where the port has no such counters."""


def read(ctx):
    from gym_anm_tpu_torch.ops import step_cuda

    solves = getattr(step_cuda, "LANE_SOLVES", None)
    counts = getattr(step_cuda, "read_iteration_counts", None)
    if not solves or counts is None:
        return None
    return counts()[0] / solves
