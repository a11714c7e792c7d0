"""The port's SAC trainer against the JAX package's, with carried weights.

The JAX trainer's loss functions are taken from its own program
(``make_train_step`` -> ``grad_update`` -> ``critic_loss_fn``,
``actor_loss_fn``) and run in float64 on the flax weights cast to float64;
the port's trainer gets the same weights through ``params_from_flax``.
Given the same pre-squash noise (drawn from the JAX key, as the JAX
functions draw it): the Q values, the Bellman target, the critic loss and
the actor loss agree to 1e-9.  The ring buffer's writes equal
``_store_chunk``'s across a wrap.  Then a small learning-signal test on
ANM6Easy, as ``tests/test_sac.py`` has.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gym_anm_tpu.envs.anm6.anm6_easy import make_core as jax_make_core
from gym_anm_tpu.rl import SACConfig as JaxSACConfig, SACTrainer as JaxSACTrainer

from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.rl import SACConfig, SACTrainer
from gym_anm_tpu_torch.rl.sac import params_from_flax


HIDDEN = (32, 32)
N = 64  # sampled transitions
CFG = dict(buffer_capacity=64, collect_steps=2, grad_steps=2, train_batch=N, hidden=HIDDEN)


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    """The JAX trainer, its state in float64 and the functions of its
    train step and gradient update."""
    jt = JaxSACTrainer(jax_make_core(dtype=jnp.float64), 8, JaxSACConfig(**CFG), seed=0)
    state = jax.tree.map(lambda x: np.asarray(x, np.float64), jt.state)
    fns = jt.make_train_step()
    fns = dict(zip(fns.__code__.co_freevars, (c.cell_contents for c in fns.__closure__)))
    gu = fns["grad_update"]
    fns.update(zip(gu.__code__.co_freevars, (c.cell_contents for c in gu.__closure__)))
    return jt, state, fns


def _trainers():
    jt, state, fns = _jax_trainer()
    t = SACTrainer(make_core(torch.float64, "cpu"), 8, SACConfig(**CFG), seed=3)
    for name, sd in params_from_flax(state, HIDDEN).items():
        getattr(t, name).load_state_dict(sd)
    return jt, state, t, fns


def _batch(t, seed=0):
    rng = np.random.default_rng(seed)
    obs_n, act_n = t.core.obs_n, t.core.action_n
    obs = lambda: t.obs_centre.numpy() + t.obs_scale.numpy() * rng.normal(size=(N, obs_n))
    u = np.tanh(rng.normal(size=(N, act_n)))
    return obs(), u, rng.normal(size=N) * 20.0, obs(), rng.uniform(size=N) < 0.2


def test_q_target_and_losses_match_jax_f64():
    jt, state, t, fns = _trainers()
    batch = _batch(t)
    tb = tuple(torch.tensor(x) for x in batch)
    key_c, key_a = jax.random.split(jax.random.PRNGKey(5))
    A = t.core.action_n
    eps_c = np.asarray(jax.random.normal(key_c, (N, A), jnp.float64))
    eps_a = np.asarray(jax.random.normal(key_a, (N, A), jnp.float64))

    @jax.jit
    def jax_side(state, batch):
        c_loss, (q_mean,) = fns["critic_loss_fn"](state["critic"], state, batch, key_c)
        obs, u, reward, next_obs, done = batch
        q1, q2 = jt.critic.apply(state["critic"], jt._norm_obs(obs), u)
        # The Bellman target, from the JAX trainer's own sampler and critic.
        u_next, logp_next = jt._sample_u(state["actor"], next_obs, key_c)
        q1t, q2t = jt.critic.apply(state["target"], jt._norm_obs(next_obs), u_next)
        nonterm = 1.0 - done.astype(reward.dtype)
        cfg = jt.cfg
        target = cfg.reward_scale * reward + cfg.gamma * nonterm * (
            jnp.minimum(q1t, q2t) - jnp.exp(state["log_alpha"]) * logp_next
        )
        a_loss, logp = fns["actor_loss_fn"](state["actor"], state, obs, key_a)
        return c_loss, q_mean, q1, q2, target, a_loss, logp

    c_loss, q_mean, q1, q2, target, a_loss, logp = (np.asarray(x) for x in jax_side(state, batch))
    loss, pq1, pq2, ptarget = t.critic_loss(tb, torch.tensor(eps_c))
    pa_loss, plogp = t.actor_loss(tb[0], torch.tensor(eps_a))
    got = [loss, pq1.mean(), pq1, pq2, ptarget, pa_loss, plogp]
    for name, a, b in zip(("c_loss", "q_mean", "q1", "q2", "target", "a_loss", "logp"), got,
                          (c_loss, q_mean, q1, q2, target, a_loss, logp)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-9, err_msg=name)
    # The batch has terminal transitions, and the target masks them.
    done = batch[4]
    np.testing.assert_allclose(ptarget.numpy()[done], 0.05 * batch[2][done], rtol=0, atol=1e-12)


def test_replay_writes_equal_store_chunk():
    jt, _, t, _ = _trainers()
    rng = np.random.default_rng(1)
    jrb, rb = jt._empty_replay, t.empty_replay()
    for _ in range(10):  # 80 transitions into 64 slots: the ring wraps
        chunk = (rng.normal(size=(8, t.core.obs_n)), np.tanh(rng.normal(size=(8, t.core.action_n))),
                 rng.normal(size=8), rng.normal(size=(8, t.core.obs_n)), rng.uniform(size=8) < 0.3)
        jrb = jt._store_chunk(jrb, *(jnp.asarray(c) for c in chunk))
        rb = t._store_chunk(rb, *(torch.tensor(c) for c in chunk))
    assert (rb.ptr, rb.size) == (int(jrb.ptr), int(jrb.size)) == (80, 64)
    for a, b in zip(rb[:5], jrb[:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sac_learns_on_anm6easy():
    """The collect-phase reward rises once the critic has seen collapse
    penalties (the early signal of the PPO test: stop collapsing the grid)."""
    cfg = SACConfig(buffer_capacity=2**13, collect_steps=16, grad_steps=64, train_batch=256, hidden=(64, 64), lr=1e-3)
    trainer = SACTrainer(make_core(torch.float32, "cpu"), 32, cfg, seed=0)
    history = trainer.train(iterations=6)
    for m in history:
        assert all(np.isfinite(v) for v in m.values()) and m["alpha"] > 0.0
    first3 = np.mean([m["mean_reward"] for m in history[:3]])
    last3 = np.mean([m["mean_reward"] for m in history[-3:]])
    assert last3 > first3 + 5.0, (first3, last3)
