"""The CUDA graph runner of ``LockstepEnv.step`` (``core/graph.py::
GraphedStep``), driven on the CPU with a stand-in for the graph that runs
the captured step again on its static buffers (``tests/graph_standin.py``).

ANM6Easy and feeder33 on ``tree`` at B=64, 64 steps from NumPy actions, the
graphed steps against the eager ones: the outputs and the final state are
equal bit for bit, with lanes terminating and reborn; a returned tensor
stays as it was after later steps; the task's hooks run once a step each,
vars first; a ``reset(seed)``, a caller's own ``needs_reset`` and a caller's
own state mid-stream are copied in; K1's launches and lane-solves are the
eager step's (two a step) and the engagement counters add up; the plain
solvers stay eager.  Imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.core import graph as core_graph, transition
from gym_anm_tpu_torch.core.env_core import state_tensors, take_lanes
from gym_anm_tpu_torch.envs import vector_core
from gym_anm_tpu_torch.envs.vector_core import LockstepEnv
from gym_anm_tpu_torch.ops import tree_cuda

from tests.graph_standin import HostGraph

B = 64
STEPS = 64
# The task's make_core keywords: at feeder33's budget random actions
# terminate no lane in 64 steps, so a budget of 3 NR iterations forces some.
TASKS = {"anm6easy": {}, "feeder33": {"pf_max_iter": 3}}
# The replaced-state run: 24 steps, a reset(seed=7) before step 6, the
# caller's needs_reset before step 12 and the caller's state before step 18.
REPLACED_STEPS, RESEED, NEW_NEEDS, NEW_STATE = 24, 6, 12, 18


def _counters():
    return [tree_cuda.KERNEL_LAUNCHES, tree_cuda.LANE_SOLVES, vector_core.LOCKSTEP_GRAPH_CAPTURES,
            vector_core.LOCKSTEP_GRAPH_REPLAYS, vector_core.LOCKSTEP_EAGER_CALLS]


def _lockstep_run(task, graph, replaced=False, pf_method="tree", steps=STEPS):
    """``steps`` steps of a B=64 ``LockstepEnv`` of ``task``, the graph
    runner engaged on the CPU (``graph``) or not; the plain twin's solve
    counts as a K1 launch.  With ``replaced``, the state and flags are
    replaced mid-stream (``RESEED``, ``NEW_NEEDS``, ``NEW_STATE``).  Returns
    what each step returned (outputs, then the state) with a copy taken
    then, the hook calls and the counters' increments."""
    with pytest.MonkeyPatch.context() as mp:
        solve = transition.solve_pfe_tree

        def counted(*args, **kwargs):
            tree_cuda.KERNEL_LAUNCHES += 1
            return solve(*args, **kwargs)

        mp.setattr(transition, "solve_pfe_tree", counted)
        if graph:
            mp.setattr(core_graph, "GRAPH_DEVICE", "cpu")
            mp.setattr(core_graph, "cuda_graph", HostGraph)
        core = check.task_make_core(task)(dtype=torch.float32, device="cpu", pf_method=pf_method, **TASKS[task])
        calls = []
        f_vars, f_init = core.next_vars_fn, core.init_state_fn

        def next_vars_fn(s, generator):
            calls.append("vars")
            return f_vars(s, generator)

        def init_state_fn(generator, batch_size):
            calls.append("init")
            return f_init(generator, batch_size)

        core.next_vars_fn, core.init_state_fn = next_vars_fn, init_state_fn
        lock = LockstepEnv(core, B, seed=5)
        lock.reset()
        rng = np.random.default_rng(1)
        lo, hi = np.asarray(core.action_low), np.asarray(core.action_high)
        calls.clear()
        c0 = _counters()
        returned = []
        for t in range(steps):
            if replaced and t == RESEED:
                lock.reset(seed=7)
            if replaced and t == NEW_NEEDS:
                lock.needs_reset = torch.arange(B) % 5 == 0
            if replaced and t == NEW_STATE:
                lock.es = take_lanes(lock.es, torch.roll(torch.arange(B), 3))
            vs = lock.step((lo + (hi - lo) * rng.random((B, core.action_n))).astype(np.float32))
            ts = list(vs) + state_tensors(lock.es)
            assert lock.needs_reset is vs.terminated
            returned.append((ts, [x.clone() for x in ts]))
        return returned, calls, [b - a for a, b in zip(c0, _counters())]


@pytest.fixture(scope="module")
def lockstep_runs():
    cache = {}

    def get(task, graph, replaced=False):
        key = (task, graph, replaced)
        if key not in cache:
            cache[key] = _lockstep_run(task, graph, replaced, steps=REPLACED_STEPS if replaced else STEPS)
        return cache[key]

    return get


def _assert_equal_runs(got, want):
    assert len(got) == len(want)
    for (g, _), (w, _) in zip(got, want):
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize(
    "case", ["bit_identical", "returned_unchanged", "hooks_once", "caller_replaced_state", "counters",
             "plain_solvers_eager"])
@pytest.mark.parametrize("task", list(TASKS))
def test_lockstep_graph_runner_on_host(lockstep_runs, task, case):
    if case == "bit_identical":
        got, want = lockstep_runs(task, True)[0], lockstep_runs(task, False)[0]
        terminated = torch.stack([ts[2] for ts, _ in got])
        assert bool(terminated[:-1].any())  # lanes terminated, and were reborn on the next step
        _assert_equal_runs(got, want)
    elif case == "returned_unchanged":
        returned = lockstep_runs(task, True)[0]
        assert len(returned) == STEPS
        for ts, copies in returned:
            for x, c in zip(ts, copies):
                torch.testing.assert_close(x, c, rtol=0, atol=0, equal_nan=True)
    elif case == "hooks_once":
        assert lockstep_runs(task, True)[1] == ["vars", "init"] * STEPS == lockstep_runs(task, False)[1]
    elif case == "caller_replaced_state":
        got, calls, c_g = lockstep_runs(task, True, replaced=True)
        want = lockstep_runs(task, False, replaced=True)[0]
        assert calls.count("init") > REPLACED_STEPS  # the reset's draws between the steps'
        assert c_g[2:] == [1, REPLACED_STEPS - 1, 1]
        _assert_equal_runs(got, want)
    elif case == "counters":
        c_g, c_e = lockstep_runs(task, True)[2], lockstep_runs(task, False)[2]
        # Two K1 launches a step, whichever way the step ran: the step's and
        # the fresh states'.
        assert c_g[:2] == c_e[:2] == [2 * STEPS, 2 * B * STEPS]
        assert c_g[2:] == [1, STEPS - 1, 1] and c_e[2:] == [0, 0, STEPS]
    else:
        # The plain twin ends its NR loop on a host read of the lanes'
        # convergence, which no graph holds: its steps run eagerly.
        c = _lockstep_run(task, True, pf_method="tree_xla", steps=3)[2]
        assert c[2:] == [0, 0, 3]
