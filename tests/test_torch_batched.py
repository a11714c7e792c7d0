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
from gym_anm_tpu_torch.core.state import SIM_FIELDS
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.batched import BatchedEnv, take_lanes
from gym_anm_tpu_torch.errors import EnvInitializationError


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
