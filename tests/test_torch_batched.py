"""Auto-reset of the port's ``BatchedEnv`` against the JAX package's.

* One step in float64 of the JAX package's auto-reset test grid (two buses
  whose in-episode load collapses the grid on about half of the lanes,
  ``tests/test_auto_reset.py``) through ``BatchedEnv.step_fn`` of the JAX
  package in pool mode and in step mode, and through the port's step and
  :meth:`rebirth` given the same draws: the JAX internal variables, pool
  indices and single-attempt reset's initial states, re-derived here from
  its key.  Observations, state vectors, rewards and ``terminated`` agree
  to 1e-8.
* The port's ``step_fn`` is the step, the draw and the rebirth, in that
  order on its generator; rollouts with a policy and in both auto-reset
  modes on ANM6Easy; ``reset(strict=True)``.
* The step's CUDA graph runner (``core/graph.py``), driven on the CPU with a
  stand-in for the graph that runs the captured step again on its static
  buffers: ANM6Easy (``tree``) and feeder33 (``fused``) at B=64, two 64-step
  pool segments, equal the eager step bit for bit; a returned tensor stays
  as it was after the next step; the task's hooks run once a step and once
  a segment; two states stepped in turns still match; the kernels' launch
  counters and the engagement counters add up.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_anm_tpu.core.env_core import EnvCore as JaxEnvCore, EnvState as JaxEnvState
from gym_anm_tpu.core.grid import build_grid as jax_build_grid
from gym_anm_tpu.core.state import SimState as JaxSimState
from gym_anm_tpu.envs.batched import BatchedEnv as JaxBatchedEnv

from gym_anm_tpu_torch.core.env_core import EnvCore
from gym_anm_tpu_torch.core.grid import build_grid
from gym_anm_tpu_torch.core.obs import state_values_spec
from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.core import graph as core_graph, transition
from gym_anm_tpu_torch.core.state import SIM_FIELDS
from gym_anm_tpu_torch.envs import batched
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.core.env_core import state_tensors, take_lanes
from gym_anm_tpu_torch.envs.batched import BatchedEnv
from gym_anm_tpu_torch.errors import EnvInitializationError
from gym_anm_tpu_torch import ops
from gym_anm_tpu_torch.ops import kernel_modules, step_cuda, tree_cuda

from tests.graph_standin import HostGraph


B = 64
# Two buses: a load of -3000 MW across the 0.1 p.u. line diverges, -20 MW
# converges (the grid of tests/test_auto_reset.py).
NET = {
    "baseMVA": 100,
    "bus": np.array([[0, 0, 132, 1.0, 1.0], [1, 1, 33, 1.1, 0.9]]),
    "device": np.array(
        [[0, 0, 0, None, 200, -200, 200, -200] + [None] * 7, [1, 1, -1, 0.2, 0, -5000] + [None] * 9], dtype=object
    ),
    "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 30, 1, 0]]),
}
CORE_KW = dict(K=0, gamma=0.995, costs_clipping=(1, 100), max_iter=10, pf_method="scan", reset_attempts=1)


def _jax_collapse_core():
    spec, _ = jax_build_grid(NET, delta_t=0.25, lamb=100, dtype=np.float64)
    n_s0 = 2 * spec.n_dev + spec.n_des + spec.n_gen

    def init_fn(key):
        p = -15.0 - 10.0 * jax.random.uniform(key, (), spec.dtype)
        return jnp.zeros((n_s0,), spec.dtype).at[1].set(p).at[spec.n_dev + 1].set(p * 0.2)

    def next_vars_fn(s, key):
        bad = jax.random.uniform(key, ()) < 0.5
        return jnp.where(bad, -3000.0, -20.0).reshape(1).astype(spec.dtype)

    return JaxEnvCore(spec, obs_values=state_values_spec(spec, 0), init_state_fn=init_fn, next_vars_fn=next_vars_fn,
                      stochastic_vars=True, **CORE_KW)


def _to_jax(es):
    sim = JaxSimState(**{k: jnp.asarray(getattr(es.sim, k).numpy()) for k in SIM_FIELDS})
    return JaxEnvState(sim, jnp.asarray(es.aux.numpy()), jnp.asarray(es.terminated.numpy()),
                       jnp.asarray(es.state_vec.numpy()))


def test_auto_reset_matches_jax_f64():
    jcore = _jax_collapse_core()
    spec, _ = build_grid(NET, delta_t=0.25, lamb=100, dtype=np.float64)
    core = EnvCore(spec, device="cpu", dtype=torch.float64, obs_values=state_values_spec(spec, 0), **CORE_KW)
    rng = np.random.default_rng(0)
    s0 = np.zeros((2, B, core.expected_s0_n))
    s0[..., 1] = -15.0 - 10.0 * rng.uniform(size=(2, B))
    s0[..., spec.n_dev + 1] = 0.2 * s0[..., 1]
    es, fresh = (core.env_state_from_s0(torch.tensor(s)) for s in s0)
    actions = np.zeros((B, core.action_n))
    key = jax.random.PRNGKey(7)
    jpool = JaxBatchedEnv(jcore, B, auto_reset=True, auto_reset_mode="pool")
    jstep = JaxBatchedEnv(jcore, B, auto_reset=True, auto_reset_mode="step")

    def run(es, fresh, actions, key):
        # The draws of BatchedEnv.step_fn, re-derived from its key.
        k_vars, k_reset = jax.random.split(key)
        vars = jax.vmap(jcore.next_vars_fn)(es.state_vec, jax.random.split(k_vars, B))
        idx = jax.random.randint(k_reset, (B,), 0, B)
        s0 = jax.vmap(jcore.init_state_fn)(jax.random.split(k_reset, B))
        return jpool.step_fn(es, actions, key, fresh=fresh), jstep.step_fn(es, actions, key), vars, idx, s0

    (jes_p, jout_p), (jes_s, jout_s), vars, idx, s0_step = jax.jit(run)(
        _to_jax(es), _to_jax(fresh), jnp.asarray(actions), key
    )

    env = BatchedEnv(core, B, auto_reset=True)
    es_new, out = core.step(es, torch.tensor(actions), torch.tensor(np.asarray(vars)))
    reborn = out.terminated.numpy()
    assert 0.2 < reborn.mean() < 0.8
    pool_draw = take_lanes(fresh, torch.tensor(np.asarray(idx), dtype=torch.long))
    step_draw = core.env_state_from_s0(torch.tensor(np.asarray(s0_step)))
    for draw, jes, jout in ((pool_draw, jes_p, jout_p), (step_draw, jes_s, jout_s)):
        es_f, out_f = env.rebirth(es_new, out, draw)
        np.testing.assert_array_equal(out_f.terminated.numpy(), np.asarray(jout.terminated))
        np.testing.assert_array_equal(es_f.terminated.numpy(), np.asarray(jes.terminated))
        for name in ("obs", "state_vec", "reward"):
            np.testing.assert_allclose(getattr(out_f, name).numpy(), np.asarray(getattr(jout, name)), rtol=0,
                                       atol=1e-8, err_msg=name)
        np.testing.assert_allclose(es_f.state_vec.numpy(), np.asarray(jes.state_vec), rtol=0, atol=1e-8)
        np.testing.assert_allclose(es_f.sim.bus_v_re.numpy(), np.asarray(jes.sim.bus_v_re), rtol=0, atol=1e-8)
        # Reborn lanes are live and carry their fresh state's observation.
        assert not es_f.terminated.numpy()[reborn].any()
        np.testing.assert_array_equal(out_f.obs.numpy()[reborn], core.observation(draw).numpy()[reborn])


def test_step_fn_steps_draws_and_rebirths():
    core = make_core(torch.float64, "cpu", pf_max_iter=3)
    env = BatchedEnv(core, B, generator=torch.Generator().manual_seed(1), auto_reset=True)
    es, _ = env.reset()
    fresh = env.fresh_states()
    actions = env.random_actions()
    es_a, out_a = env.step_fn(es, actions, torch.Generator().manual_seed(5), fresh=fresh)
    gen = torch.Generator().manual_seed(5)
    es_new, out = core.step(es, actions, core.next_vars_fn(es.state_vec, gen))
    drawn = env.draw(fresh, gen)
    es_b, out_b = env.rebirth(es_new, out, drawn)
    assert out.terminated.any()
    for a, b in zip(out_a, out_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(es_a.state_vec, es_b.state_vec, rtol=0, atol=0)
    # Lanes reborn from converged pool entries are live again.
    live = out.terminated & ~drawn.terminated
    assert bool(live.any()) and not bool(es_a.terminated[live].any())


@pytest.mark.parametrize("mode", ["pool", "step"])
def test_auto_reset_rollout(mode):
    core = make_core(torch.float64, "cpu", pf_max_iter=3)
    env = BatchedEnv(core, B, generator=torch.Generator().manual_seed(2), auto_reset=True, auto_reset_mode=mode)
    es, first = env.reset()
    lo, hi = (torch.tensor(a) for a in (core.action_low, core.action_high))

    def policy(scale, obs, gen):  # uniform over a share of the action box
        u = torch.rand((obs.shape[0], core.action_n), generator=gen, dtype=obs.dtype)
        return lo + scale * u * (hi - lo)

    es, (obs, actions, reward, terminated) = env.rollout(es, 3, policy, 1.0)
    assert obs.shape == (3, B, core.obs_n) and actions.shape == (3, B, core.action_n)
    assert reward.shape == terminated.shape == (3, B) and bool(torch.isfinite(reward).all())
    assert bool(terminated.any())
    # Terminated lanes are reborn: after the segment only a lane whose fresh
    # state failed to converge is terminated, and only where the last step
    # terminated it.
    assert not bool((es.terminated & ~terminated[-1]).any())
    assert int(es.terminated.sum()) < int(terminated.sum())
    es, (reward, terminated) = env.rollout(es, 2)
    assert reward.shape == (2, B)


def test_reset_strict_raises_when_every_attempt_fails():
    core = make_core(torch.float64, "cpu", pf_max_iter=0)  # no NR step: no s0 converges
    env = BatchedEnv(core, 4, reset_attempts=2)
    es, out = env.reset()
    assert bool(out.terminated.all())
    with pytest.raises(EnvInitializationError, match="2 initial states for 4/4 lanes"):
        env.reset(strict=True)
    with pytest.raises(ValueError, match="auto_reset_mode"):
        BatchedEnv(core, 4, auto_reset=True, auto_reset_mode="lane")


KERNEL_MODULES = kernel_modules()
GRAPH_TASKS = {"anm6easy": ("tree", "solve_pfe_tree", tree_cuda), "feeder33": ("fused", "fused_transition", step_cuda)}


def _counters():
    return [m.KERNEL_LAUNCHES for m in KERNEL_MODULES] + [tree_cuda.LANE_SOLVES] + [
        batched.STEP_GRAPH_CAPTURES, batched.STEP_GRAPH_REPLAYS, batched.STEP_EAGER_CALLS]


def _graph_run(task, graph, alternate):
    """A B=64 run of ``task`` with pool auto-reset through ``step_fn``, the
    graph runner engaged on the CPU (``graph``) or not.  The path's solve
    counts as a kernel launch.  Two 64-step segments of one state, or
    (``alternate``) one 16-step segment of two states stepped in turns.
    Returns what each step returned, a copy of it taken then, the per-segment
    rewards and terminations, the final states, the hook calls and the
    counters' increments."""
    pf_method, solver, module = GRAPH_TASKS[task]
    with pytest.MonkeyPatch.context() as mp:
        original = getattr(transition, solver)

        def counted(*args, **kwargs):
            module.KERNEL_LAUNCHES += 1
            return original(*args, **kwargs)

        mp.setattr(transition, solver, counted)
        if graph:
            mp.setattr(core_graph, "GRAPH_DEVICE", "cpu")
            mp.setattr(core_graph, "cuda_graph", HostGraph)
        core = check.task_make_core(task)(dtype=torch.float32, device="cpu", pf_method=pf_method)
        env = BatchedEnv(core, B, generator=torch.Generator().manual_seed(11), auto_reset=True)
        calls = {"vars": 0, "init": 0}
        f_vars, f_init, f_step = core.next_vars_fn, core.init_state_fn, env.step_fn

        def next_vars_fn(s, generator):
            calls["vars"] += 1
            return f_vars(s, generator)

        def init_state_fn(generator, batch_size):
            calls["init"] += 1
            return f_init(generator, batch_size)

        returned = []

        def step_fn(es, actions, generator=None, fresh=None):
            es, out = f_step(es, actions, generator, fresh)
            ts = state_tensors(es) + list(out)
            returned.append((ts, [t.clone() for t in ts]))
            return es, out

        core.next_vars_fn, core.init_state_fn, env.step_fn = next_vars_fn, init_state_fn, step_fn
        states = [env.reset()[0] for _ in range(2 if alternate else 1)]
        c0 = _counters()
        calls.update(vars=0, init=0)
        ys = []
        if alternate:
            fresh = env.fresh_states()
            for _ in range(16):
                for i, es in enumerate(states):
                    states[i], out = env.step_fn(es, env.random_actions(), fresh=fresh)
                    ys.append((out.reward, out.terminated))
        else:
            for _ in range(2):
                states[0], y = env.rollout(states[0], 64)
                ys.append(y)
        return returned, ys, states, calls, [b - a for a, b in zip(c0, _counters())]


@pytest.fixture(scope="module")
def graph_runs():
    cache = {}

    def get(task, graph, alternate=False):
        key = (task, graph, alternate)
        if key not in cache:
            cache[key] = _graph_run(task, graph, alternate)
        return cache[key]

    return get


@pytest.mark.parametrize("case", ["bit_identical", "returned_unchanged", "hooks_once", "alternating", "counters"])
@pytest.mark.parametrize("task", list(GRAPH_TASKS))
def test_step_graph_runner_on_host(graph_runs, task, case):
    steps = 2 * 64
    if case == "bit_identical":
        _, ys_g, es_g, _, _ = graph_runs(task, True)
        _, ys_e, es_e, _, _ = graph_runs(task, False)
        assert bool(torch.cat([t for _, t in ys_g]).any())  # lanes were reborn from the pool
        for yg, ye in zip(ys_g, ys_e):
            for a, b in zip(yg, ye):
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        for a, b in zip(state_tensors(es_g[0]), state_tensors(es_e[0])):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    elif case == "returned_unchanged":
        returned = graph_runs(task, True)[0]
        assert len(returned) == steps
        for ts, copies in returned:
            for t, c in zip(ts, copies):
                torch.testing.assert_close(t, c, rtol=0, atol=0, equal_nan=True)
    elif case == "hooks_once":
        assert graph_runs(task, True)[3] == {"vars": steps, "init": 2} == graph_runs(task, False)[3]
    elif case == "alternating":
        _, ys_g, es_g, _, c_g = graph_runs(task, True, alternate=True)
        _, ys_e, es_e, _, _ = graph_runs(task, False, alternate=True)
        assert c_g[4:] == [1, 2 * 16 - 1, 1]
        for yg, ye in zip(ys_g, ys_e):
            for a, b in zip(yg, ye):
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        for sg, se in zip(es_g, es_e):
            for a, b in zip(state_tensors(sg), state_tensors(se)):
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    else:
        c_g, c_e = graph_runs(task, True)[4], graph_runs(task, False)[4]
        k = KERNEL_MODULES.index(GRAPH_TASKS[task][2])
        # A launch a step and one a segment's pool, whichever way the step ran.
        assert c_g[:4] == c_e[:4] and c_g[k] == steps + 2
        assert c_g[3] == (B * (steps + 2) if GRAPH_TASKS[task][2] is tree_cuda else 0)  # tree lane-solves
        assert c_g[4:] == [1, steps - 1, 1] and c_e[4:] == [0, 0, steps]


@pytest.mark.parametrize("env_cls", ["BatchedEnv", "LockstepEnv"])
def test_step_graph_follows_a_swapped_grid(env_cls):
    """A core whose ``grid`` is swapped (here for the other projection form)
    gets a graph of its own, and both match the eager step bit for bit."""
    import dataclasses

    from gym_anm_tpu_torch.envs import vector_core
    from gym_anm_tpu_torch.ops.projection import LanesProjector

    def run(graph):
        with pytest.MonkeyPatch.context() as mp:
            if graph:
                mp.setattr(core_graph, "GRAPH_DEVICE", "cpu")
                mp.setattr(core_graph, "cuda_graph", HostGraph)
            core = make_core(torch.float32, "cpu")
            if env_cls == "BatchedEnv":
                env = BatchedEnv(core, B, generator=torch.Generator().manual_seed(4))
                es = [env.reset()[0]]

                def step():
                    es[0], out = env.step(es[0], env.random_actions())
                    return list(out) + state_tensors(es[0])

                counters = lambda: [batched.STEP_GRAPH_CAPTURES, batched.STEP_GRAPH_REPLAYS, batched.STEP_EAGER_CALLS]
            else:
                env = vector_core.LockstepEnv(core, B, seed=4)
                env.reset()
                rng = np.random.default_rng(4)
                lo, hi = np.asarray(core.action_low), np.asarray(core.action_high)

                def step():
                    vs = env.step((lo + (hi - lo) * rng.random((B, core.action_n))).astype(np.float32))
                    return list(vs) + state_tensors(env.es)

                counters = lambda: [vector_core.LOCKSTEP_GRAPH_CAPTURES, vector_core.LOCKSTEP_GRAPH_REPLAYS,
                                    vector_core.LOCKSTEP_EAGER_CALLS]
            G = np.concatenate([np.asarray(core.spec.gen_G), np.asarray(core.spec.des_G)], axis=0)
            c0, outs = counters(), []
            for form in ("running_min", "stacked"):
                core.grid = dataclasses.replace(core.grid, projector=LanesProjector(G, "cpu", torch.float32, form=form))
                for _ in range(3):
                    outs.append(step())
            return outs, [b - a for a, b in zip(c0, counters())]

    outs_g, c_g = run(True)
    outs_e, c_e = run(False)
    assert c_g == [2, 2 * 2, 2]  # each grid: an eager warm-up, a capture and two replays
    assert c_e == [0, 0, 2 * 3]
    for a, b in zip(outs_g, outs_e):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("pf_method", ["scan", "tree_xla"])
def test_step_graph_leaves_plain_solvers_eager(monkeypatch, pf_method):
    """The plain solvers end their loops on a host read of the lanes'
    convergence, which no graph holds: their steps run eagerly."""
    monkeypatch.setattr(core_graph, "GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(core_graph, "cuda_graph", HostGraph)
    env = BatchedEnv(make_core(torch.float32, "cpu", pf_method=pf_method), B, auto_reset=True)
    es, _ = env.reset()
    c0 = _counters()
    es, _ = env.rollout(es, 3)
    assert [b - a for a, b in zip(c0, _counters())][4:] == [0, 0, 3]


def test_every_kernel_module_is_registered():
    """A replayed step adds its captured launches to the counter of every
    module ``ops.KERNEL_MODULES`` names: each module of ``ops/`` that counts
    its launches has to be there, or its launches under a graph go
    uncounted."""
    import pathlib

    counting = sorted(
        f.stem for f in pathlib.Path(ops.__file__).parent.glob("*.py") if "\nKERNEL_LAUNCHES = 0\n" in f.read_text()
    )
    assert counting == sorted(ops.KERNEL_MODULES)
    assert all(hasattr(m, "KERNEL_LAUNCHES") for m in kernel_modules())


def test_step_graph_without_auto_reset_draws_no_pool_index(monkeypatch):
    """Without auto-reset a pool passed to ``step_fn`` is not drawn from:
    the graphed steps leave the generator where the eager steps leave it,
    and return the same values."""

    def run(graph):
        core = make_core(torch.float32, "cpu")
        env = BatchedEnv(core, B, generator=torch.Generator().manual_seed(5))
        step = env.step_fn if graph else env._step_eager
        es, _ = env.reset()
        pool, outs = env.fresh_states(), []
        for _ in range(4):
            es, out = step(es, env.random_actions(), fresh=pool)
            outs.append(out)
        return outs, env.generator.get_state()

    monkeypatch.setattr(core_graph, "GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(core_graph, "cuda_graph", HostGraph)
    c0 = _counters()
    outs_g, gen_g = run(True)
    assert [b - a for a, b in zip(c0, _counters())][4:] == [1, 3, 1]  # a warm-up step, then three replays
    outs_e, gen_e = run(False)
    assert torch.equal(gen_g, gen_e)
    for a, b in zip(outs_g, outs_e):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
