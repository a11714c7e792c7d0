"""The port's ``ANMVectorEnv`` lockstep core against the JAX package's.

* The pure step of ``envs/vector_core.py`` against ``ANMVectorEnv._jit_step``
  of the JAX package on ANM6Easy (``tree``) in float64: the same state,
  ``needs_reset`` (two lanes forced through a reset), actions, and the vars
  and fresh initial states JAX drew for its key, re-derived as
  ``vector.py:95-107`` draws them.  Observations, rewards, ``terminated``
  and the next states agree to 1e-8 over 6 steps.  The JAX side (its
  state after the reset, each step's draws and outputs) is recorded by
  ``scripts/gen_torch_test_refs.py`` in
  ``tests/data/torch_refs_vector_env.npz``.
* Next-step autoreset (``tests/test_vector_env.py``),
  ``tests/test_failed_reset.py::test_vector_env_reset_failed_info``, and
  the lockstep core's draw order and one-copy host conversion.

``tests/test_vector_env.py``'s other cases (spaces, shapes, seed
determinism, incomplete cores) are in ``tests/test_torch_gym_surface.py``;
this file keeps few tests so that it runs after the suite's long-running
files have started (see ``tests/test_torch_gym_env.py``).
"""

import os

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.core.state import SIM_FIELDS, env_state_from_numpy
from gym_anm_tpu_torch.envs import vector_core
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.vector import ANMVectorEnv


B = 16
ATOL = 1e-8


def test_pure_step_matches_jax():
    # JaxANMVectorEnv(make_core(dtype=float64), num_envs=B, seed=0) after
    # reset(seed=2), stepped with PRNGKey(100 + t), as recorded.
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_refs_vector_env.npz")) as z:
        j = {k: z[k] for k in z.files}
    core = make_core(torch.float64, device="cpu")
    needs = j["needs0"]
    assert needs.sum() == 2 and needs[3] and needs[11]
    es = env_state_from_numpy({k: j["init/sim/" + k] for k in SIM_FIELDS}, j["init/aux"], j["init/terminated"],
                              j["init/state_vec"], device="cpu", dtype=torch.float64)
    needs_t = torch.tensor(needs)

    rng = np.random.default_rng(0)
    reset_seen = 0
    for t in range(6):
        p = "step%d/" % t
        actions = rng.uniform(core.action_low, core.action_high, size=(B, core.action_n))
        np.testing.assert_array_equal(actions, j[p + "actions"], err_msg="re-run scripts/gen_torch_test_refs.py")
        vars, s0 = j[p + "vars"], j[p + "s0"]  # vector.py:95-107's draws for the step's key
        es, vs = vector_core.step(core, es, needs_t, torch.tensor(actions), torch.tensor(vars), torch.tensor(s0))
        np.testing.assert_array_equal(vs.terminated.numpy(), j[p + "terminated"])
        np.testing.assert_array_equal(es.terminated.numpy(), j[p + "es/terminated"])
        for got, want in ((vs.obs, j[p + "obs"]), (vs.reward, j[p + "reward"]), (es.state_vec, j[p + "es/state_vec"]),
                          (es.sim.bus_v_re, j[p + "es/bus_v_re"]), (es.sim.bus_v_im, j[p + "es/bus_v_im"])):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg="step %d" % t)
        # Reset lanes: reward 0, not terminated, the fresh state's observation.
        assert not vs.terminated[needs_t].any() and (vs.reward[needs_t] == 0).all()
        fresh = core.env_state_from_s0(torch.tensor(s0))
        torch.testing.assert_close(vs.obs[needs_t], core.observation(fresh)[needs_t], rtol=0, atol=0)
        reset_seen += int(needs.sum())
        needs = j[p + "needs_next"]
        needs_t = vs.terminated
    assert reset_seen >= 2


def test_next_step_autoreset():
    """A lane that terminates at step t is re-initialized at t+1 with reward
    0 and terminated False (Gymnasium >= 1.0 NEXT_STEP semantics).  A budget
    of 3 NR iterations leaves some lanes unconverged every few steps."""
    venv = ANMVectorEnv(make_core(torch.float64, device="cpu", pf_max_iter=3), num_envs=8, seed=3)
    venv.reset(seed=3)
    a = np.tile(np.asarray(venv.single_action_space.high), (8, 1))
    terminated_seen, resets = None, 0
    for t in range(12):
        obs, rew, term, trunc, _ = venv.step(a)
        if terminated_seen is not None:
            # the lanes that terminated last step have been reset
            assert not term[terminated_seen].any()
            assert (rew[terminated_seen] == 0.0).all()
            # reset observations are live states, not the absorbing zeros
            assert np.abs(obs[terminated_seen]).sum(axis=-1).min() > 0
            resets += len(terminated_seen)
        terminated_seen = np.where(term)[0] if term.any() else None
        if term.any():
            # terminal reward is the reference's -c2 / (1 - gamma)
            np.testing.assert_allclose(rew[term], -100.0 / (1 - 0.995), rtol=1e-12)
            assert (obs[term] == 0).all()
    assert resets > 0


def test_vector_env_reset_failed_info():
    # No NR iteration: no initial state converges.
    env = ANMVectorEnv(make_core(torch.float64, device="cpu", pf_max_iter=0), num_envs=4, seed=0, reset_attempts=2)
    obs, info = env.reset(seed=0)
    assert np.all(info["reset_failed"])
    assert np.all(obs == 0.0)
    # The failed lanes are flagged for autoreset: the next step retries a
    # fresh initial state instead of stepping a diverged one.
    actions = np.zeros((4, env.single_action_space.shape[0]), dtype=np.float64)
    obs, reward, terminated, truncated, _ = env.step(actions)
    assert np.all(reward == 0.0)
    assert np.all(np.isfinite(obs))
    assert not terminated.any()


def test_lockstep_draw_order_and_host_copy():
    """``LockstepEnv.step`` draws the vars, then the fresh states, on its one
    generator, and ``to_numpy`` returns what the tensors hold."""
    core = make_core(torch.float64, device="cpu", pf_max_iter=3)
    lock = vector_core.LockstepEnv(core, 8, seed=4)
    lock.reset()
    es, needs = lock.es, lock.needs_reset
    gen = torch.Generator().manual_seed(9)
    lock.generator.manual_seed(9)
    actions = torch.tensor(np.tile(core.action_high, (8, 1)))
    vs = lock.step(actions)
    d = vector_core.draw(core, es, gen)
    es_ref, vs_ref = vector_core.step(core, es, needs, actions, d.vars, d.fresh_s0)
    for a, b in zip(vs, vs_ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(lock.es.state_vec, es_ref.state_vec, rtol=0, atol=0)
    assert lock.needs_reset is vs.terminated
    obs, reward, term = vector_core.to_numpy(vs)
    np.testing.assert_array_equal(obs, vs.obs.numpy())
    np.testing.assert_array_equal(reward, vs.reward.numpy())
    np.testing.assert_array_equal(term, vs.terminated.numpy())
    with pytest.raises(RuntimeError, match="reset"):
        vector_core.LockstepEnv(core, 2).step(actions[:2])
