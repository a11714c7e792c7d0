"""The port's operators: the power flow, the projection and the
hand-written CUDA kernels."""

import importlib

# The modules of the hand-written kernels.  Each counts its launches in
# ``KERNEL_LAUNCHES``, which a CUDA graph's replay has to add to itself.
KERNEL_MODULES = ("nr_cuda", "step_cuda", "tree_cuda")


def kernel_modules() -> list:
    """The modules :data:`KERNEL_MODULES` names."""
    return [importlib.import_module("." + name, __name__) for name in KERNEL_MODULES]
