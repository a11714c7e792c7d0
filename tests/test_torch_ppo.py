"""The port's PPO trainer against the JAX package's, with carried weights.

The JAX trainer's functions are taken from its own program
(``make_train_step``'s ``loss_fn`` and ``gae``) and run in float64 on the
flax weights cast to float64; the port's trainer gets the same weights
through ``params_from_flax``.  On the same minibatch: ``_policy_logp``, the
loss and its parts, every gradient, and two steps of the clipped Adam
optimiser (``optax.chain(clip_by_global_norm, adam)``) agree to 1e-9; GAE
on the same trajectory too.  Then a small learning-signal test on ANM6Easy,
as ``tests/test_ppo.py`` has.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from gym_anm_tpu.envs.anm6.anm6_easy import make_core as jax_make_core
from gym_anm_tpu.rl import PPOConfig as JaxPPOConfig, PPOTrainer as JaxPPOTrainer
from gym_anm_tpu.rl.ppo import Transition as JaxTransition

from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.rl import PPOConfig, PPOTrainer
from gym_anm_tpu_torch.rl.ppo import Transition, gae, params_from_flax


HIDDEN = (32, 32)
N = 96  # minibatch rows


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    """The JAX trainer, its weights in float64 and the functions of its
    train step."""
    jt = JaxPPOTrainer(jax_make_core(dtype=jnp.float64), 8, JaxPPOConfig(hidden=HIDDEN), seed=0)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), jt.params)
    fns = jt.make_train_step()
    return jt, params, dict(zip(fns.__code__.co_freevars, (c.cell_contents for c in fns.__closure__)))


def _trainers():
    jt, params, fns = _jax_trainer()
    t = PPOTrainer(make_core(torch.float64, "cpu"), 8, PPOConfig(hidden=HIDDEN), seed=3)
    t.model.load_state_dict(params_from_flax(params, HIDDEN))
    return jt, params, t, fns


def _batch(t, seed=0):
    """Observations around the observation box, squashed actions, old
    log-probabilities near the policy's, advantages and returns."""
    rng = np.random.default_rng(seed)
    obs = t.obs_centre.numpy() + t.obs_scale.numpy() * rng.normal(size=(N, t.core.obs_n))
    u = np.tanh(rng.normal(size=(N, t.core.action_n)))
    with torch.no_grad():
        logp = t._policy_logp(torch.tensor(obs), torch.tensor(u))[0].numpy()
    return obs, u, logp + 0.3 * rng.normal(size=N), rng.normal(size=N) * 5.0, rng.normal(size=N) * 3.0


def _grads_as_flax(t, params):
    """The port's gradients laid out as the flax tree (weights transposed)."""
    g = {k: v.grad.numpy() for k, v in t.model.named_parameters()}
    h = len(HIDDEN)
    names = ["torso.%d" % i for i in range(h)] + ["mean", "value"]
    out = {"Dense_%d" % i: {"kernel": g[n + ".weight"].T, "bias": g[n + ".bias"]} for i, n in enumerate(names)}
    out["log_std"] = g["log_std"]
    return {"params": out}


def _close(a, b, atol=1e-9):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=atol)


def test_policy_loss_gradients_and_update_match_jax_f64():
    jt, params, t, fns = _trainers()
    batch = _batch(t)
    tb = tuple(torch.tensor(x) for x in batch)

    logp, ent, value = jax.jit(jt._policy_logp)(params, batch[0], batch[1])
    with torch.no_grad():
        ours = t._policy_logp(tb[0], tb[1])
    _close([logp, ent, value], [o.numpy() for o in ours])

    loss_and_grad = jax.jit(jax.value_and_grad(fns["loss_fn"], has_aux=True))
    (jloss, jparts), jgrads = loss_and_grad(params, batch)
    loss, parts = t.loss(tb)
    _close([jloss, *jparts], [loss.detach().numpy()] + [p.detach().numpy() for p in parts])
    loss.backward()
    _close(jgrads, _grads_as_flax(t, params))

    # Two clipped Adam steps (the second with other data, so that the moments
    # and the bias corrections move); both clip (global norm > 0.5).
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))

    @jax.jit
    def step(p, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, optax.global_norm(grads)

    opt_state, p = tx.init(params), params
    for seed in (0, 1):
        batch = _batch(t, seed)
        p, opt_state, norm = step(p, opt_state, loss_and_grad(p, batch)[1])
        assert float(norm) > 0.5
        t.update(tuple(torch.tensor(x) for x in batch))
        _close(p, {"params": _port_params_as_flax(t)}, atol=1e-12)


def _port_params_as_flax(t):
    sd = {k: v.detach().numpy() for k, v in t.model.state_dict().items()}
    names = ["torso.%d" % i for i in range(len(HIDDEN))] + ["mean", "value"]
    out = {"Dense_%d" % i: {"kernel": sd[n + ".weight"].T, "bias": sd[n + ".bias"]} for i, n in enumerate(names)}
    out["log_std"] = sd["log_std"]
    return out


def test_gae_matches_jax_f64():
    jt, _, t, fns = _trainers()
    rng = np.random.default_rng(4)
    T, B = 12, 8
    reward = rng.normal(size=(T, B)) * 10.0
    value = rng.normal(size=(T, B))
    term = rng.uniform(size=(T, B)) < 0.2
    last = rng.normal(size=B)
    z = np.zeros((T, B))
    jadv, jret = fns["gae"](JaxTransition(z, z, z, value, reward, term), last)
    adv, ret = gae(t.cfg, Transition(*(torch.tensor(x) for x in (z, z, z, value, reward, term))), torch.tensor(last))
    _close([jadv, jret], [adv.numpy(), ret.numpy()])


def test_ppo_learns_on_anm6easy():
    """The mean reward of the policy rises markedly within a few iterations
    (the early signal: stop collapsing the grid)."""
    cfg = PPOConfig(rollout_steps=16, minibatches=4, epochs=4, hidden=(64, 64), lr=3e-4)
    trainer = PPOTrainer(make_core(torch.float32, "cpu"), 64, cfg, seed=0)
    history = trainer.train(iterations=8)
    for m in history:
        assert np.isfinite(m["loss"]) and 0.0 <= m["terminated_frac"] <= 1.0
    first3 = np.mean([m["mean_reward"] for m in history[:3]])
    last3 = np.mean([m["mean_reward"] for m in history[-3:]])
    assert last3 > first3 + 10.0, (first3, last3, history)
