"""A stand-in for a CUDA graph on the CPU, for the tests of the port's graph
runner (``core/graph.py::GraphedStep``) under ``BatchedEnv`` and
``LockstepEnv``."""

from gym_anm_tpu_torch import ops


class HostGraph:
    """Stands in for a CUDA graph on the CPU (``graph.cuda_graph``): the
    capture runs the step's host code once, as ``torch.cuda.graph`` does;
    each replay runs it again on the static buffers and leaves the kernels'
    launch counters as they were, as a replay does."""

    def __init__(self, fn):
        fn()
        self.fn = fn

    def __call__(self):
        counts = [(m, name, getattr(m, name)) for m, name in ops.host_counters()]
        self.fn()
        for m, name, n in counts:
            setattr(m, name, n)
