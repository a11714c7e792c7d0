"""Share of the whole-transition kernel's (K3's) launches in this process that
solved in the tree form, in percent: ``TREE_LAUNCHES`` over
``KERNEL_LAUNCHES`` of ``ops/step_cuda.py`` (host counters, which a replayed
CUDA graph adds its captured launches to).  None where the port has no such
counter or K3 never launched."""


def read(ctx):
    from gym_anm_tpu_torch.ops import step_cuda

    tree = getattr(step_cuda, "TREE_LAUNCHES", None)
    launches = getattr(step_cuda, "KERNEL_LAUNCHES", 0)
    if tree is None or not launches:
        return None
    return 100.0 * tree / launches
