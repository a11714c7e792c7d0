"""An env step replayed from a CUDA graph.

On a CUDA device an env step is a few hundred small kernels, and launching
them one by one from the host takes several times their device time.  So
``BatchedEnv.step_fn`` and ``LockstepEnv.step`` draw eagerly, then replay
the rest of the step from a :class:`GraphedStep` (one a :func:`graph_key`)
wherever :func:`graphed` says that a graph can hold it.
"""

from __future__ import annotations

from operator import is_not

import torch

from ..ops import host_counters
from .transition import capturable, resolve_solver_path

# The device type whose steps replay a graph.  The CPU tests set "cpu" and
# swap :func:`cuda_graph` for a stand-in that runs the captured step again.
GRAPH_DEVICE = "cuda"


def graphed(core, device: torch.device) -> bool:
    """Whether a step of ``core`` on ``device`` replays a graph: on a
    :data:`GRAPH_DEVICE`, where the core solves in a kernel (the plain
    solvers end their loops on a host read, which no graph holds)."""
    return device.type == GRAPH_DEVICE and capturable(resolve_solver_path(core.grid, core.pf_method, core.nr_pivot)[0])


def graph_key(core, tensors) -> tuple:
    """The key of the graph that a step of ``core`` with ``tensors`` replays:
    their shapes and dtypes, the TF32 setting (a captured product keeps its
    own) and ``core.grid`` (which a caller may swap, e.g. for another
    projection form; the runner holds it, so that its id stays unique)."""
    return tuple((t.shape, t.dtype) for t in tensors) + (torch.backends.cuda.matmul.allow_tf32, id(core.grid))


class _Packing:
    """Tensors of fixed shapes and dtypes laid out in one byte buffer, the
    tensors of each dtype side by side (16-byte aligned)."""

    def __init__(self, like):
        by_dtype = {}
        for i, t in enumerate(like):
            by_dtype.setdefault(t.dtype, []).append(i)
        self.n, self.groups, off = len(like), [], 0
        for dtype, pos in by_dtype.items():
            off = -(-off // 16) * 16
            numels = [like[i].numel() for i in pos]
            nbytes = sum(numels) * dtype.itemsize
            self.groups.append((dtype, off, nbytes, numels, [like[i].shape for i in pos], pos))
            off += nbytes
        self.nbytes = off

    def views(self, buf) -> list:
        """The packed tensors as views of the byte buffer ``buf``."""
        out = [None] * self.n
        for dtype, off, nbytes, numels, shapes, pos in self.groups:
            for i, part, shape in zip(pos, buf[off : off + nbytes].view(dtype).split(numels), shapes):
                out[i] = part.view(shape)
        return out

    def copy(self, dst, src):
        """``dst[i] <- src[i]`` for this packing's views ``dst``: one foreach
        copy a dtype."""
        for *_, pos in self.groups:
            torch._foreach_copy_([dst[i] for i in pos], [src[i] for i in pos])


def cuda_graph(fn):
    """Capture ``fn``'s device work into a CUDA graph and return its replay.
    ``fn``'s host code runs once, during the capture; no kernel runs."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def counted_graph(fn):
    """:func:`cuda_graph` of ``fn``, with the kernels' host counters
    (``ops.HOST_COUNTERS``: their launches, K1's lane-solves) kept exact.
    The capture runs ``fn``'s host code once, so the counts it made are
    taken back, and each call of the returned replay adds them again."""
    counters = host_counters()
    before = [getattr(module, name) for module, name in counters]
    graph = cuda_graph(fn)
    counts = []
    for (module, name), n0 in zip(counters, before):
        n = getattr(module, name) - n0
        if n:
            setattr(module, name, n0)
            counts.append((module, name, n))

    def replay():
        graph()
        for module, name, n in counts:
            setattr(module, name, getattr(module, name) + n)

    return replay


class GraphedStep:
    """A step replayed from a CUDA graph, for one :func:`graph_key`.

    ``step(carried, held, inputs) -> (carried_new, blocks)`` maps lists of
    tensors: ``carried`` is what the step reads and ``carried_new`` (made
    anew, of the same shapes and dtypes) what it leaves in its place, the
    state; ``held`` is read across calls, the pool; ``inputs`` are the
    call's own, the actions and draws, then the :attr:`drawn` buffers, which
    the caller draws into before the call; ``blocks`` are lists of outputs.

    The first call runs ``step`` eagerly (it loads the kernels and makes the
    libraries' handles) and the second captures it (:func:`counted_graph`).
    The graph reads each group from a static buffer, its tensors packed by
    dtype, writes each block into a buffer of its own and ``carried_new``
    over ``carried``.  A call copies the inputs in (a copy a dtype), the
    carried group only when it holds another tensor than the previous call
    returned and the held group only when it holds another tensor than the
    last it copied (matched by identity: a tensor changed in place is not
    copied in again), replays, and returns the carried buffer and each
    block's cloned (a copy each), so that no later replay writes into a
    tensor a call returned; a returned tensor keeps its whole clone alive.

    ``grid`` (the core's) is held, so that its id keys this graph alone;
    ``counters`` is ``(namespace, captures, replays, eager)``: a module's
    ``globals()`` and the names of its ints that count the captures, the
    replays and the eager calls.
    """

    def __init__(self, step, grid, counters, drawn=()):
        self.step = step
        self.grid = grid
        self.counts, self.captures, self.replays, self.eager = counters
        self.drawn = list(drawn)
        self.warm = False
        self.replay = None

    def __call__(self, carried: list, held: list, inputs: list):
        if self.replay is None:
            if not self.warm:
                self.warm = True
                self.counts[self.eager] += 1
                return self.step(carried, held, inputs + self.drawn)
            self._capture(carried, held, inputs)
        self.inputs.copy(self.input_views, inputs)
        if self.last is None or any(map(is_not, carried, self.last)):
            self.carried.copy(self.carried_views, carried)
        if self.held_src is None or any(map(is_not, held, self.held_src)):
            self.held.copy(self.held_views, held)
            self.held_src = held
        self.replay()
        self.counts[self.replays] += 1
        self.last = self.carried.views(self.carried_buf.clone())
        return self.last, [packing.views(buf.clone()) for packing, buf in zip(self.out, self.out_bufs)]

    def _capture(self, carried, held, inputs):
        device = carried[0].device

        def packed(like):
            packing = _Packing(like)
            buf = torch.zeros((packing.nbytes,), dtype=torch.uint8, device=device)
            return packing, buf, packing.views(buf)

        self.carried, self.carried_buf, self.carried_views = packed(carried)
        self.held, _, self.held_views = packed(held)
        self.inputs, _, self.input_views = packed(inputs)
        self.last = self.held_src = self.out = None
        self.replay = counted_graph(self._run)
        self.counts[self.captures] += 1

    def _run(self):
        """The captured step: each block into its buffer, allocated at the
        capture and so in the graph's memory; then ``carried_new`` over the
        carried buffer."""
        carried, blocks = self.step(self.carried_views, self.held_views, self.input_views + self.drawn)
        if self.out is None:
            self.out = [_Packing(block) for block in blocks]
            device = carried[0].device
            self.out_bufs = [torch.empty((p.nbytes,), dtype=torch.uint8, device=device) for p in self.out]
            self.out_views = [p.views(buf) for p, buf in zip(self.out, self.out_bufs)]
        for packing, views, block in zip(self.out, self.out_views, blocks):
            packing.copy(views, block)
        self.carried.copy(self.carried_views, carried)
