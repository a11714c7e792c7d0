"""The port's ANM6Easy env core against the JAX package's, in float64.

The same initial states, actions and internal variables (made with numpy)
go through ``env_state_from_s0`` and ``step`` of both cores; the JAX PRNG
streams cannot be reproduced, so the task hooks are checked for what they
must give: ``next_vars`` exactly, and initial states on the profile tables
and inside their bounds."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gym_anm_tpu.envs.anm6.anm6_easy import make_core as jax_make_core

from gym_anm_tpu_torch.core.state import SIM_FIELDS, env_state_from_numpy
from gym_anm_tpu_torch.envs.anm6.anm6_easy import _get_gen_time_series, _get_load_time_series, make_core


def _inputs(core, B, seed):
    """Initial states from the port's distribution and uniform actions."""
    g = torch.Generator().manual_seed(seed)
    s0 = core.init_state_fn(g, B).numpy()
    rng = np.random.default_rng(seed)
    lo, hi = core.action_low, core.action_high
    actions = rng.uniform(lo, hi, (2, B, lo.shape[0]))
    return s0, actions


def _step_both(core, jcore, es, jes, action):
    vars = core.next_vars_fn(es.state_vec, None)
    jvars = jax.vmap(jcore.next_vars_fn, in_axes=(0, None))(jes.state_vec, None)
    np.testing.assert_array_equal(vars.numpy(), np.asarray(jvars))
    es, out = core.step(es, torch.tensor(action), vars)
    jes, jout = jax.jit(jcore.step)(jes, jnp.asarray(action), jvars)
    return es, out, jes, jout


def _assert_out_close(out, jout):
    np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(jout.terminated))
    for k in ("state_vec", "obs", "reward", "e_loss", "penalty"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(jout, k)), rtol=0, atol=1e-8, err_msg=k)


def test_env_core_matches_jax_f64():
    # A 3-iteration power-flow budget leaves some step solves unconverged,
    # so both live and terminated lanes occur.
    core = make_core(dtype=torch.float64, pf_max_iter=3)
    jcore = jax_make_core(dtype=jnp.float64, pf_max_iter=3)
    B = 128
    s0, actions = _inputs(core, B, 0)

    es = core.env_state_from_s0(torch.tensor(s0))
    jes = jax.jit(jcore.env_state_from_s0)(s0)
    np.testing.assert_array_equal(es.terminated.numpy(), np.asarray(jes.terminated))
    np.testing.assert_allclose(es.state_vec.numpy(), np.asarray(jes.state_vec), rtol=0, atol=1e-8)
    np.testing.assert_allclose(core.observation(es).numpy(), np.asarray(jcore.observation(jes)), rtol=0, atol=1e-8)

    prev0 = es.terminated.numpy()
    es, out, jes, jout = _step_both(core, jcore, es, jes, actions[0])
    _assert_out_close(out, jout)
    # Newly collapsed lanes get the terminal reward -c2 / (1 - gamma); lanes
    # terminated before the step get 0.
    new = out.terminated.numpy() & ~prev0
    assert new.any() and not out.terminated.numpy().all()
    np.testing.assert_allclose(out.reward.numpy()[new], -100.0 / (1.0 - 0.995))
    assert not out.reward.numpy()[prev0].any()

    # The JAX state carried into the port (its arrays as numpy) steps alike.
    carried = env_state_from_numpy(
        {k: np.asarray(getattr(jes.sim, k)) for k in SIM_FIELDS},
        np.asarray(jes.aux), np.asarray(jes.terminated), np.asarray(jes.state_vec), dtype=torch.float64,
    )
    es2, out2, _, jout2 = _step_both(core, jcore, carried, jes, actions[1])
    _assert_out_close(out2, jout2)
    # Terminated lanes earn 0 and stay in the zero state.
    prev = out.terminated
    assert bool((out2.reward[prev] == 0).all()) and bool((out2.state_vec[prev] == 0).all())
    assert bool((out2.obs[prev] == 0).all())


def test_init_state_on_profiles_and_in_bounds():
    core = make_core(dtype=torch.float32)
    s0 = core.init_state_fn(torch.Generator().manual_seed(1), 4096).numpy().astype(np.float64)
    loads, gens = _get_load_time_series(), _get_gen_time_series()
    t0 = s0[:, -1].astype(int)
    assert np.array_equal(s0[:, -1], t0) and t0.min() >= 0 and t0.max() <= 95
    assert len(np.unique(t0)) == 96
    for i, dev_id in enumerate([1, 3, 5]):
        np.testing.assert_allclose(s0[:, dev_id], loads[i, t0], rtol=1e-6)
        np.testing.assert_allclose(s0[:, 7 + dev_id], 0.2 * loads[i, t0], rtol=1e-6)
    for idx, (dev_id, qmax) in enumerate(zip([2, 4], [0.3, 0.5])):
        np.testing.assert_allclose(s0[:, dev_id], gens[idx, t0], rtol=1e-6)
        np.testing.assert_allclose(s0[:, 15 + idx], gens[idx, t0], rtol=1e-6)
        q = s0[:, 7 + dev_id]
        assert q.min() >= -qmax and q.max() <= qmax and q.std() > 0.2 * qmax
    soc = s0[:, 14]
    assert soc.min() >= 0.0 and soc.max() <= 1.0 and soc.std() > 0.2
    # Slack entries and the storage injection start at zero.
    assert not s0[:, [0, 6, 7, 13]].any()
    # Every sampled state converges (the task's reset budget is 1).
    es, out = core.reset(torch.Generator().manual_seed(2), 256)
    assert not bool(out.failed.any()) and int(out.n_tries.max()) == 1
