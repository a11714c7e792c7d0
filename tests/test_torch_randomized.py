"""The port's domain-randomized fleets against the JAX package's.

* ``perturb_branches`` with every sigma non-zero, and the cores of both
  fleet builders, from the same numpy seed: bit-equal branch tables and
  admittance matrices (float64) in both packages.
* A fleet step in float64: ANM6Easy (G=3, the tree path) from the JAX
  fleet's reset states carried across, three steps of the same actions
  (its internal variables are deterministic; the JAX fleet's states and
  steps as ``scripts/gen_torch_test_refs.py`` records them in
  ``tests/data/torch_refs_randomized.npz``); feeder33 (G=2) given the
  internal variables the JAX fleet step draws from its key.  Observations,
  state vectors, rewards and ``terminated`` agree to 1e-8 per variant.
* The port of each test of ``tests/test_randomized.py``, under the same
  tiny configurations; two nominal variants of one fleet draw different
  initial states; a fleet's G-tuple state round-trips through a checkpoint;
  a fleet refuses variants of different sizes.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_anm_tpu.core.env_core import EnvState as JaxEnvState
from gym_anm_tpu.core.state import SimState as JaxSimState
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33
from gym_anm_tpu.envs.randomized import (
    MultiBatchedEnv as JaxMultiBatchedEnv,
    perturb_branches as jax_perturb_branches,
    randomized_anm6easy_cores as jax_randomized_anm6easy_cores,
    randomized_feeder33_cores as jax_randomized_feeder33_cores,
)

from gym_anm_tpu_torch.checkpoint import load_pytree, save_pytree
from gym_anm_tpu_torch.constants import BRANCH_H
from gym_anm_tpu_torch.core.state import SIM_FIELDS, env_state_from_numpy
from gym_anm_tpu_torch.envs import (
    BatchedEnv,
    MultiBatchedEnv,
    perturb_branches,
    ppo_trainer_for_fleet,
    randomized_anm6easy_cores,
    randomized_feeder33_cores,
    sac_trainer_for_fleet,
)
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder33 import make_core as f33_make_core
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network
from gym_anm_tpu_torch.rl import PPOConfig, SACConfig


F64 = dict(dtype=torch.float64, device="cpu")
ATOL = 1e-8


def _to_jax(es):
    sim = JaxSimState(**{k: jnp.asarray(getattr(es.sim, k).numpy()) for k in SIM_FIELDS})
    return JaxEnvState(sim, jnp.asarray(es.aux.numpy()), jnp.asarray(es.terminated.numpy()),
                       jnp.asarray(es.state_vec.numpy()))


def _from_jax(jes):
    return env_state_from_numpy(
        {k: np.asarray(getattr(jes.sim, k)) for k in SIM_FIELDS}, np.asarray(jes.aux), np.asarray(jes.terminated),
        np.asarray(jes.state_vec), **F64,
    )


def _assert_out_close(out, jout, g):
    """``jout``: a JAX fleet step's output, or its arrays by name."""
    get = (lambda k: jout[k]) if isinstance(jout, dict) else (lambda k: getattr(jout, k))
    np.testing.assert_array_equal(out.terminated[g].numpy(), np.asarray(get("terminated")[g]))
    for name in ("obs", "state_vec", "reward"):
        np.testing.assert_allclose(getattr(out, name)[g].numpy(), np.asarray(get(name)[g]), rtol=0,
                                   atol=ATOL, err_msg="variant %d %s" % (g, name))


# ----------------------------------------------------------------------------
# Networks

@pytest.mark.parametrize("name", ["anm6", "feeder33"])
def test_perturb_branches_equals_jax(name):
    net, jnet = {"anm6": (anm6_network, jax_anm6_network), "feeder33": (make_feeder_network(), JAX_F33)}[name]
    sigmas = dict(r_sigma=0.2, x_sigma=0.15, b_sigma=0.1, rate_sigma=0.05)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):  # the second draw continues both streams
        br = perturb_branches(net, rng, **sigmas)["branch"]
        jbr = jax_perturb_branches(jnet, jrng, **sigmas)["branch"]
        np.testing.assert_array_equal(br, jbr)
    br0 = np.array(net["branch"], dtype=float)
    for col in ("BR_R", "BR_X", "RATE"):
        assert not np.allclose(br[:, BRANCH_H[col]], br0[:, BRANCH_H[col]]), col


@pytest.mark.parametrize("name", ["anm6easy", "feeder33"])
def test_randomized_cores_equal_jax(name):
    port, jax_fn = {
        "anm6easy": (randomized_anm6easy_cores, jax_randomized_anm6easy_cores),
        "feeder33": (randomized_feeder33_cores, jax_randomized_feeder33_cores),
    }[name]
    cores = port(3, seed=0, **F64)
    jcores = jax_fn(3, seed=0, dtype=jnp.float64)
    for c, jc in zip(cores, jcores):
        np.testing.assert_array_equal(np.asarray(c.spec.Y_re), np.asarray(jc.spec.Y_re))
        np.testing.assert_array_equal(np.asarray(c.spec.Y_im), np.asarray(jc.spec.Y_im))
    # Variant 0 is the nominal grid; the others differ from it and from each other.
    assert np.array_equal(np.asarray(cores[0].spec.Y_re), np.asarray(port(1, seed=5, **F64)[0].spec.Y_re))
    assert not np.allclose(np.asarray(cores[1].spec.Y_re), np.asarray(cores[2].spec.Y_re))


# ----------------------------------------------------------------------------
# Fleet steps in float64

def _jax_anm6_fleet():
    """The JAX fleet's reset states (``reset(PRNGKey(0))`` of G=3 variants x
    8 lanes) and three steps of fixed actions, as recorded."""
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_refs_randomized.npz")) as z:
        j = {k[len("anm6/"):]: z[k] for k in z.files if k.startswith("anm6/")}
    states = tuple(
        env_state_from_numpy({k: j["init/%d/sim/%s" % (g, k)] for k in SIM_FIELDS},
                             *(j["init/%d/%s" % (g, k)] for k in ("aux", "terminated", "state_vec")), **F64)
        for g in range(3)
    )
    outs = [{k: j["step%d/%s" % (t, k)] for k in ("obs", "state_vec", "reward", "terminated")} for t in range(3)]
    return states, j["actions"], outs


def test_anm6easy_fleet_step_matches_jax_f64():
    states, actions, jouts = _jax_anm6_fleet()
    cores = randomized_anm6easy_cores(3, seed=0, r_sigma=0.2, x_sigma=0.2, **F64)
    lo, hi = np.asarray(cores[0].action_low), np.asarray(cores[0].action_high)
    np.testing.assert_array_equal(actions, np.random.default_rng(0).uniform(lo, hi, (3, 3, 8, lo.shape[0])),
                                  err_msg="re-run scripts/gen_torch_test_refs.py")
    fleet = MultiBatchedEnv(cores, 8)
    for t, jout in enumerate(jouts):
        states, out = fleet.step(states, torch.tensor(actions[t]))
        assert out.obs.shape == (3, 8, fleet.obs_n) and out.reward.shape == (3, 8)
        for g in range(3):
            _assert_out_close(out, jout, g)
    # The grids differ, so the same actions give different rewards.
    assert not np.allclose(out.reward[1].numpy(), out.reward[2].numpy())


def _jax_feeder33_fleet_step(states):
    """One JAX feeder33 fleet step from the port's states carried across, and
    the internal variables it drew: ``BatchedEnv.step_fn``'s draws,
    re-derived from each variant's key in one program with the step."""
    jcores = jax_randomized_feeder33_cores(2, seed=0, r_sigma=0.2, x_sigma=0.2, dtype=jnp.float64)
    fleet = JaxMultiBatchedEnv(jcores, lanes_per_variant=4)
    lo, hi = np.asarray(jcores[0].action_low), np.asarray(jcores[0].action_high)
    actions = np.random.default_rng(1).uniform(lo, hi, (2, 4, lo.shape[0]))

    def run(states, actions, key):
        keys = jax.random.split(key, 2)
        vars = [
            jax.vmap(c.next_vars_fn)(states[g].state_vec, jax.random.split(jax.random.split(keys[g])[0], 4))
            for g, c in enumerate(jcores)
        ]
        return fleet._step_fn(states, actions, key)[1], vars

    jout, vars = jax.jit(run)(tuple(map(_to_jax, states)), jnp.asarray(actions), jax.random.PRNGKey(4))
    return actions, jout, [np.asarray(v) for v in vars]


def test_feeder33_fleet_step_given_jax_vars_matches_jax_f64():
    cores = randomized_feeder33_cores(2, seed=0, r_sigma=0.2, x_sigma=0.2, **F64)
    fleet = MultiBatchedEnv(cores, 4)
    states, _ = fleet.reset()
    actions, jout, jvars = _jax_feeder33_fleet_step(states)
    for g in range(2):
        cores[g].next_vars_fn = lambda s, generator, v=torch.tensor(jvars[g]): v
    states, out = fleet.step(states, torch.tensor(actions))
    for g in range(2):
        _assert_out_close(out, jout, g)


# ----------------------------------------------------------------------------
# The port of tests/test_randomized.py

def test_perturb_branches_properties():
    rng = np.random.default_rng(0)
    net = perturb_branches(anm6_network, rng, r_sigma=0.2, x_sigma=0.2)
    br0 = np.array(anm6_network["branch"], dtype=float)
    br1 = np.array(net["branch"], dtype=float)
    # Topology untouched, impedances jittered but sign/zero-preserving.
    for col in ("F_BUS", "T_BUS", "RATE"):
        np.testing.assert_array_equal(br0[:, BRANCH_H[col]], br1[:, BRANCH_H[col]])
    r0, r1 = br0[:, BRANCH_H["BR_R"]], br1[:, BRANCH_H["BR_R"]]
    assert ((r0 == 0) == (r1 == 0)).all()
    assert (r1[r0 > 0] > 0).all()
    assert not np.allclose(r0, r1)
    # The original dict is untouched.
    np.testing.assert_array_equal(np.array(anm6_network["branch"], dtype=float), br0)
    # The perturbed network builds a valid core.
    make_core(network=net, device="cpu")


def test_multi_env_nominal_variant_matches_single_env():
    """Two copies of the nominal grid inside the fleet produce identical
    trajectories, and variant 0 matches a plain BatchedEnv driven by the
    same actions."""
    L = 8
    multi = MultiBatchedEnv([make_core(**F64), make_core(**F64)], lanes_per_variant=L)
    single = BatchedEnv(make_core(**F64), batch_size=L)
    es_s, _ = single.reset()
    states = (es_s, es_s)
    for _ in range(3):
        a = single.random_actions()
        states, out = multi.step(states, torch.stack([a, a]))
        # ANM6Easy's vars are deterministic, so both nominal variants agree.
        torch.testing.assert_close(out.reward[0], out.reward[1], rtol=0, atol=0)
        es_s, out_s = single.step(es_s, a)
        torch.testing.assert_close(out.reward[0], out_s.reward, rtol=0, atol=0)
        torch.testing.assert_close(out.obs[0], out_s.obs, rtol=0, atol=0)


def test_randomized_fleet_variants_differ_and_rollout_runs():
    L = 4
    cores = randomized_anm6easy_cores(n_variants=3, seed=0, r_sigma=0.3, x_sigma=0.3, **F64)
    multi = MultiBatchedEnv(cores, lanes_per_variant=L)
    states, _ = multi.reset()
    states, (rew, term) = multi.rollout(states, 8)
    assert rew.shape == term.shape == (8, 3, L)
    assert bool(torch.isfinite(rew).all())

    # Same action sequence on different grids yields different physics.
    multi = MultiBatchedEnv(cores, lanes_per_variant=L, generator=torch.Generator().manual_seed(5))
    states, _ = multi.reset()
    states, out = multi.step(states, torch.zeros((3, L, cores[0].action_n), dtype=torch.float64))
    assert not np.allclose(out.reward[1].numpy(), out.reward[2].numpy())


def test_policy_rollout_over_fleet():
    """A single policy function drives the whole heterogeneous fleet."""
    L = 4
    cores = randomized_anm6easy_cores(n_variants=2, seed=1, **F64)
    multi = MultiBatchedEnv(cores, lanes_per_variant=L)
    states, _ = multi.reset()

    def zero_policy(args, obs, generator):
        assert obs.shape == (2, L, cores[0].obs_n)
        return torch.zeros((2, L, cores[0].action_n), dtype=torch.float64)

    states, (obs, actions, rew, term) = multi.rollout(states, 4, zero_policy)
    assert obs.shape == (4, 2, L, cores[0].obs_n)
    assert actions.shape == (4, 2, L, cores[0].action_n)
    assert bool(torch.isfinite(rew).all())


def test_fleet_ppo_trains(tmp_path):
    """One PPO policy trains against the whole heterogeneous fleet:
    mechanics, finite losses, and a checkpoint round trip."""
    cores = randomized_anm6easy_cores(n_variants=2, seed=0, r_sigma=0.2, x_sigma=0.2, device="cpu")
    cfg = PPOConfig(rollout_steps=8, minibatches=2, epochs=1, hidden=(32, 32))
    trainer = ppo_trainer_for_fleet(cores, lanes_per_variant=8, config=cfg, seed=0)
    assert trainer.B == 16
    history = trainer.train(iterations=2)
    assert len(history) == 2
    for m in history:
        assert np.isfinite(m["loss"]) and np.isfinite(m["mean_reward"])
        assert 0.0 <= m["terminated_frac"] <= 1.0
    trainer.save(str(tmp_path / "ppo.npz"))
    other = ppo_trainer_for_fleet(cores, lanes_per_variant=8, config=cfg, seed=1)
    other.load(str(tmp_path / "ppo.npz"))
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(other.model.state_dict()[k], v, rtol=0, atol=0)


def test_feeder33_fleet_builds_and_steps():
    """Perturbed 33-bus variants share layout, differ electrically, and a
    fleet rollout stays finite."""
    cores = randomized_feeder33_cores(n_variants=2, seed=0, r_sigma=0.2, x_sigma=0.2, **F64)
    assert cores[0].action_n == cores[1].action_n
    assert not np.allclose(np.asarray(cores[0].spec.Y_re), np.asarray(cores[1].spec.Y_re))
    multi = MultiBatchedEnv(cores, lanes_per_variant=4)
    states, first = multi.reset()
    states, (rew, term) = multi.rollout(states, 3)
    assert rew.shape == (3, 2, 4)
    assert bool(torch.isfinite(rew).all())


def test_fleet_sac_trains(tmp_path):
    """SAC over a heterogeneous fleet: mechanics, finite metrics, and a
    checkpoint round trip."""
    cores = randomized_anm6easy_cores(n_variants=2, seed=0, r_sigma=0.2, x_sigma=0.2, device="cpu")
    B = 2 * 8
    cfg = SACConfig(collect_steps=4, buffer_capacity=B * 16, train_batch=32, hidden=(32, 32), grad_steps=2)
    trainer = sac_trainer_for_fleet(cores, lanes_per_variant=8, config=cfg, seed=0)
    history = trainer.train(iterations=2, warmup_rounds=1)
    assert len(history) == 2
    for m in history:
        assert all(np.isfinite(v) for v in m.values())
    trainer.save(str(tmp_path / "sac.npz"))
    other = sac_trainer_for_fleet(cores, lanes_per_variant=8, config=cfg, seed=1)
    other.load(str(tmp_path / "sac.npz"))
    torch.testing.assert_close(other.log_alpha, trainer.log_alpha, rtol=0, atol=0)
    for k, v in trainer.actor.state_dict().items():
        torch.testing.assert_close(other.actor.state_dict()[k], v, rtol=0, atol=0)


# ----------------------------------------------------------------------------
# Draws, checkpoints, sizes

def test_nominal_variants_draw_different_initial_states():
    multi = MultiBatchedEnv([make_core(**F64), make_core(**F64)], lanes_per_variant=16)
    states, first = multi.reset()
    assert not torch.equal(first.state_vec[0], first.state_vec[1])
    pools = multi.fresh_states()
    assert not torch.equal(pools[0].state_vec, pools[1].state_vec)
    # The fleet's generator is every variant's.
    assert all(env.generator is multi.generator for env in multi.envs)


def test_fleet_state_checkpoint_roundtrip(tmp_path):
    cores = randomized_anm6easy_cores(2, seed=0, r_sigma=0.2, x_sigma=0.2, **F64)
    multi = MultiBatchedEnv(cores, lanes_per_variant=4, auto_reset=True)
    states, _ = multi.reset()
    states, _ = multi.rollout(states, 2)
    path = str(tmp_path / "fleet.npz")
    save_pytree(path, states)
    restored = load_pytree(path, multi.reset()[0])
    assert isinstance(restored, tuple) and len(restored) == 2
    actions = multi.random_actions(torch.Generator().manual_seed(9))
    _, out_a = multi.step(states, actions, torch.Generator().manual_seed(3))
    _, out_b = multi.step(restored, actions, torch.Generator().manual_seed(3))
    for a, b in zip(out_a, out_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fleet_refuses_variants_of_different_sizes():
    with pytest.raises(ValueError, match="share action/observation sizes"):
        MultiBatchedEnv([make_core(device="cpu"), f33_make_core(device="cpu")], lanes_per_variant=2)
    with pytest.raises(ValueError, match="at least one"):
        MultiBatchedEnv([], lanes_per_variant=2)
