"""The port's operators: the power flow, the projection and the
hand-written CUDA kernels."""

import importlib

# The modules of the hand-written kernels.  Each counts its launches in
# ``KERNEL_LAUNCHES``, which a CUDA graph's replay has to add to itself.
KERNEL_MODULES = ("nr_cuda", "step_cuda", "tree_cuda")
# The host counters a kernel module may keep, each of which a replay adds to
# itself: its launches, (the tree-NR and fused-transition kernels') its
# lane-solves and (the fused-transition kernel's) its launches in the tree
# form.
HOST_COUNTERS = ("KERNEL_LAUNCHES", "LANE_SOLVES", "TREE_LAUNCHES")


def kernel_modules() -> list:
    """The modules :data:`KERNEL_MODULES` names."""
    return [importlib.import_module("." + name, __name__) for name in KERNEL_MODULES]


def host_counters() -> list:
    """``(module, name)`` of each of :data:`HOST_COUNTERS` that a kernel
    module keeps."""
    return [(m, name) for m in kernel_modules() for name in HOST_COUNTERS if hasattr(m, name)]
