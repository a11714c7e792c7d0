"""Newton iterations a lane-solve of the tree-NR kernel (K1), over the whole
process: the port's device counter of the iterations (``ops/tree_cuda.py``,
added in the kernel's epilogue, so the steps replayed from a CUDA graph are
counted too) over its host count of lane-solves.  None where the port has no
such counters."""


def read(ctx):
    from gym_anm_tpu_torch.ops import tree_cuda

    solves = getattr(tree_cuda, "LANE_SOLVES", None)
    counts = getattr(tree_cuda, "read_iteration_counts", None)
    if not solves or counts is None:
        return None
    return counts()[0] / solves
