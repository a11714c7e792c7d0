"""Soft Actor-Critic over batched ANM environments on one device.

The counterpart of ``gym_anm_tpu.rl.sac``: a device-resident ring replay
buffer, a tanh-squashed Gaussian actor, twin Q critics with
polyak-averaged targets, and an auto-tuned entropy temperature.  One
iteration runs ``collect_steps`` batched environment steps (storing ``B``
transitions each, with pool auto-reset) and then ``grad_steps``
critic / actor / temperature updates.  With ``mesh=``
(:mod:`gym_anm_tpu_torch.parallel`) it trains data-parallel, one rank a
card.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..checkpoint import load_pytree, save_pytree
from ..envs.batched import BatchedEnv
from ..parallel import sharding
from ._nn import adam_state, dense, flax_dense, load_adam_state, obs_norm_tables, squashed_logp


def _mlp(sizes, gen):
    return nn.ModuleList(dense(a, b, gen) for a, b in zip(sizes[:-1], sizes[1:]))


class Actor(nn.Module):
    """MLP producing a tanh-squashed diagonal-Gaussian policy: ``hidden``
    relu layers, a mean head and a ``log_std`` head clipped to [-5, 2]."""

    def __init__(self, obs_n: int, action_n: int, hidden=(256, 256), generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.torso = _mlp((obs_n,) + tuple(hidden), gen)
        self.mean = dense(tuple(hidden)[-1], action_n, gen)
        self.log_std = dense(tuple(hidden)[-1], action_n, gen)

    def forward(self, obs):
        x = obs
        for layer in self.torso:
            x = torch.relu(layer(x))
        return self.mean(x), torch.clamp(self.log_std(x), -5.0, 2.0)


class TwinQ(nn.Module):
    """Two independent Q(s, a) relu MLPs (clipped double-Q)."""

    def __init__(self, obs_n: int, action_n: int, hidden=(256, 256), generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        sizes = (obs_n + action_n,) + tuple(hidden) + (1,)
        self.q1 = _mlp(sizes, gen)
        self.q2 = _mlp(sizes, gen)

    @staticmethod
    def _head(layers, x):
        for layer in layers[:-1]:
            x = torch.relu(layer(x))
        return layers[-1](x)[..., 0]

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self._head(self.q1, x), self._head(self.q2, x)


def actor_params_from_flax(params_np, hidden) -> dict:
    """The :class:`Actor` ``state_dict`` from the JAX package's flax
    ``Actor`` parameters (NumPy arrays): ``Dense_i`` for the hidden layers,
    then the mean and the log-std heads."""
    p = params_np["params"]
    h = len(hidden)
    out = {}
    for i in range(h):
        out.update(flax_dense("torso.%d" % i, p["Dense_%d" % i]))
    out.update(flax_dense("mean", p["Dense_%d" % h]))
    out.update(flax_dense("log_std", p["Dense_%d" % (h + 1)]))
    return out


def critic_params_from_flax(params_np, hidden) -> dict:
    """The :class:`TwinQ` ``state_dict`` from the JAX package's flax
    ``TwinQ`` parameters: the first Q's layers are ``Dense_0 ..
    Dense_h``, the second's the next ``h + 1``."""
    p = params_np["params"]
    per_q = len(hidden) + 1
    out = {}
    for q in range(2):
        for i in range(per_q):
            out.update(flax_dense("q%d.%d" % (q + 1, i), p["Dense_%d" % (q * per_q + i)]))
    return out


def params_from_flax(state_np, hidden) -> dict:
    """``{"actor": ..., "critic": ..., "target": ...}`` state dicts from the
    actor, critic and target parameter trees of the JAX package's SAC
    state."""
    return {
        "actor": actor_params_from_flax(state_np["actor"], hidden),
        "critic": critic_params_from_flax(state_np["critic"], hidden),
        "target": critic_params_from_flax(state_np["target"], hidden),
    }


@dataclasses.dataclass
class SACConfig:
    buffer_capacity: int = 2**17
    collect_steps: int = 32  # env steps per iteration (B transitions each)
    grad_steps: int = 32  # gradient updates per iteration
    train_batch: int = 256
    gamma: float = 0.995
    tau: float = 0.005  # polyak coefficient for target critics
    lr: float = 3e-4
    hidden: tuple = (256, 256)
    # Same scaling rationale as PPOConfig.reward_scale: ANM terminal rewards
    # are -c2/(1-gamma) and would otherwise dominate the Bellman targets.
    reward_scale: float = 0.05
    init_log_alpha: float = -1.6  # alpha ~ 0.2


class Replay(NamedTuple):
    """Ring buffer of transitions on the device.

    ``action_u`` is the squashed action in [-1, 1]; next observations of
    lanes that terminated are the auto-reset observations, which the
    Bellman target masks with (1 - done).  ``ptr`` (the next write offset,
    monotonic) and ``size`` (filled entries, <= capacity) are host ints.
    """

    obs: torch.Tensor  # [C, obs_n]
    action_u: torch.Tensor  # [C, action_n]
    reward: torch.Tensor  # [C]
    next_obs: torch.Tensor  # [C, obs_n]
    terminated: torch.Tensor  # [C] bool
    ptr: int
    size: int


class SACTrainer:
    """Soft Actor-Critic over a :class:`BatchedEnv` with pool auto-reset.

    ``env`` (optional) replaces the default ``BatchedEnv(core, batch_size,
    auto_reset=True)`` with any object exposing ``reset()`` / ``step_fn(es,
    actions [B, A], generator, fresh=None)``.  ``generator`` (default: one
    on the core's device seeded with ``seed``) draws every sample; the
    weights are initialised from ``seed``.

    ``mesh`` (a :func:`~gym_anm_tpu_torch.parallel.sharding.make_mesh`)
    trains data-parallel, one rank a card, the core on the rank's device:
    ``batch_size``, ``buffer_capacity`` and ``train_batch`` are global and
    each rank holds its share (``self.B`` lanes with their own generator,
    seeded from ``(seed, rank)``, and a ring of its own lanes' transitions,
    as the JAX package shards the ring over dp).  The weights and the
    temperature are broadcast from rank 0 at construction; the critic's and
    the actor's gradients and the temperature's are averaged over the ranks
    before each step, so a dp update equals the one-device update on the
    union of the ranks' samples.  Metrics are means over the ranks.  SAC is
    data-parallel only, as in the JAX dry run: on a ``dp x tp`` mesh it
    shards over the dp dimension (ranks, seeds and every collective are the
    dp coordinate's and the dp group's), and the ranks of one dp coordinate
    repeat the same work on replicated weights.
    """

    def __init__(self, core, batch_size: int, config: Optional[SACConfig] = None, seed: int = 0, env=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        self.cfg = cfg = config or SACConfig()
        self.core = core
        self.mesh = mesh
        world = 1 if mesh is None else sharding.dp_size(mesh)
        if int(batch_size) % world or cfg.buffer_capacity % world or cfg.train_batch % world:
            raise ValueError("batch_size, buffer_capacity and train_batch must split evenly over %d ranks" % world)
        self.B = int(batch_size) // world
        self.capacity, self.train_batch = cfg.buffer_capacity // world, cfg.train_batch // world
        if self.capacity % self.B:
            raise ValueError("buffer_capacity must be a multiple of batch_size (aligned ring writes)")
        self.device, self.dtype = core.device, core.dtype
        if generator is None:
            rank_seed = seed if mesh is None else sharding.rank_seed(seed, sharding.dp_rank(mesh))
            generator = torch.Generator(device=self.device).manual_seed(rank_seed)
        self.generator = generator
        self.env = env if env is not None else BatchedEnv(core, self.B, generator=generator, auto_reset=True)
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)
        self.lo, self.hi = t(core.action_low), t(core.action_high)
        self.obs_centre, self.obs_scale = obs_norm_tables(core, self.dtype, self.device)

        obs_n, act_n = core.obs_gather.n, core.action_n
        init = torch.Generator().manual_seed(seed)
        to = lambda m: m.to(self.device, self.dtype)
        self.actor = to(Actor(obs_n, act_n, cfg.hidden, init))
        self.critic = to(TwinQ(obs_n, act_n, cfg.hidden, init))
        self.log_alpha = nn.Parameter(torch.tensor(cfg.init_log_alpha, dtype=self.dtype, device=self.device))
        if mesh is not None:
            sharding.broadcast_params_([self.actor, self.critic], mesh)
            with torch.no_grad():
                sharding.broadcast_(self.log_alpha.data, mesh)
        self.target = copy.deepcopy(self.critic).requires_grad_(False)
        self.opt_actor = torch.optim.Adam(self.actor.parameters(), lr=cfg.lr, eps=1e-8)
        self.opt_critic = torch.optim.Adam(self.critic.parameters(), lr=cfg.lr, eps=1e-8)
        self.opt_alpha = torch.optim.Adam([self.log_alpha], lr=cfg.lr, eps=1e-8)
        self.target_entropy = -float(act_n)

    def empty_replay(self) -> Replay:
        C, obs_n, act_n = self.capacity, self.core.obs_gather.n, self.core.action_n
        z = lambda *shape: torch.zeros(shape, dtype=self.dtype, device=self.device)
        return Replay(
            obs=z(C, obs_n), action_u=z(C, act_n), reward=z(C), next_obs=z(C, obs_n),
            terminated=torch.zeros((C,), dtype=torch.bool, device=self.device), ptr=0, size=0,
        )

    # ------------------------------------------------------------------
    def _norm_obs(self, obs):
        return (obs - self.obs_centre) / self.obs_scale

    def _to_env_action(self, u):
        return self.lo + (u + 1.0) * 0.5 * (self.hi - self.lo)

    def _sample_u(self, actor, obs, eps=None):
        """``(u, logp)``: ``u = tanh(mean + std eps)`` from ``actor`` with
        ``eps`` standard normal (drawn from the trainer's generator unless
        given)."""
        mean, log_std = actor(self._norm_obs(obs))
        if eps is None:
            eps = torch.randn(mean.shape, generator=self.generator, device=self.device, dtype=mean.dtype)
        u = torch.tanh(mean + torch.exp(log_std) * eps)
        return u, squashed_logp(eps, log_std, u)

    # ------------------------------------------------------------------
    def _store_chunk(self, rb: Replay, obs, u, reward, next_obs, terminated) -> Replay:
        """Write a ``[B, ...]`` chunk at the ring position (capacity % B ==
        0, so a chunk never straddles the wrap point)."""
        C = self.capacity
        at = rb.ptr % C
        for buf, x in zip(rb[:5], (obs, u, reward, next_obs, terminated)):
            buf[at : at + self.B] = x
        return rb._replace(ptr=rb.ptr + self.B, size=min(rb.size + self.B, C))

    @torch.no_grad()
    def collect(self, es, rb: Replay, obs, uniform: bool):
        """``collect_steps`` env steps storing transitions, with uniform
        random actions (``uniform``) or the actor's.  Returns ``(es, rb,
        obs, (reward [T, B], terminated [T, B]))``."""
        env = self.env
        use_pool = getattr(env, "auto_reset", False) and getattr(env, "auto_reset_mode", "step") == "pool" \
            and hasattr(env, "fresh_states")
        fresh = env.fresh_states(self.generator) if use_pool else None
        rewards, terms = [], []
        for _ in range(self.cfg.collect_steps):
            if uniform:
                shape = (self.B, self.core.action_n)
                u = torch.rand(shape, generator=self.generator, device=self.device, dtype=self.dtype) * 2.0 - 1.0
            else:
                u, _ = self._sample_u(self.actor, obs)
            es, out = env.step_fn(es, self._to_env_action(u), self.generator, fresh=fresh)
            rb = self._store_chunk(rb, obs, u, out.reward, out.obs, out.terminated)
            obs = out.obs
            rewards.append(out.reward)
            terms.append(out.terminated)
        return es, rb, obs, (torch.stack(rewards), torch.stack(terms))

    # ------------------------------------------------------------------
    def critic_loss(self, batch, eps_next=None):
        """``(loss, q1, q2, target)`` of the twin critics on ``batch = (obs,
        u, reward, next_obs, done)`` against the polyak targets; the next
        actions are the actor's, with pre-squash noise ``eps_next``."""
        cfg = self.cfg
        obs, u, reward, next_obs, done = batch
        with torch.no_grad():
            u_next, logp_next = self._sample_u(self.actor, next_obs, eps_next)
            q1t, q2t = self.target(self._norm_obs(next_obs), u_next)
            alpha = torch.exp(self.log_alpha)
            nonterm = 1.0 - done.to(reward.dtype)
            target = cfg.reward_scale * reward + cfg.gamma * nonterm * (torch.minimum(q1t, q2t) - alpha * logp_next)
        q1, q2 = self.critic(self._norm_obs(obs), u)
        return 0.5 * torch.mean((q1 - target) ** 2 + (q2 - target) ** 2), q1, q2, target

    def actor_loss(self, obs, eps=None):
        """``(loss, logp)`` of the actor against the critics' minimum, with
        pre-squash noise ``eps``."""
        u, logp = self._sample_u(self.actor, obs, eps)
        q1, q2 = self.critic(self._norm_obs(obs), u)
        alpha = torch.exp(self.log_alpha).detach()
        return torch.mean(alpha * logp - torch.minimum(q1, q2)), logp

    def grad_update(self, rb: Replay):
        """One :meth:`update` on a uniform sample of ``train_batch`` (this
        rank's share) transitions of the buffer."""
        idx = torch.randint(0, max(rb.size, 1), (self.train_batch,), generator=self.generator, device=self.device)
        return self.update(tuple(x[idx] for x in rb[:5]))

    def _step(self, opt, loss, params):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            sharding.average_grads_(params, self.mesh)
        opt.step()

    def update(self, batch, eps_next=None, eps=None):
        """One critic, actor and temperature update on ``batch = (obs, u,
        reward, next_obs, done)``, then polyak averaging; ``eps_next`` and
        ``eps`` are the critic's and the actor's pre-squash noise (drawn when
        not given).  Returns ``(critic_loss, actor_loss, q_mean)``."""
        cfg = self.cfg
        c_loss, q1, _, _ = self.critic_loss(batch, eps_next)
        self._step(self.opt_critic, c_loss, list(self.critic.parameters()))

        # The actor's loss reads the updated critics and the current alpha.
        a_loss, logp = self.actor_loss(batch[0], eps)
        self._step(self.opt_actor, a_loss, list(self.actor.parameters()))

        # d/d(log_alpha) of -log_alpha * (mean logp + H_target), no gradient
        # through logp.
        self.log_alpha.grad = -(logp.detach().mean() + self.target_entropy).reshape(())
        if self.mesh is not None:
            sharding.all_reduce_mean_(self.log_alpha.grad, self.mesh)
        self.opt_alpha.step()

        with torch.no_grad():
            for t, c in zip(self.target.parameters(), self.critic.parameters()):
                t.copy_((1 - cfg.tau) * t + cfg.tau * c)
        return c_loss.detach(), a_loss.detach(), q1.detach().mean()

    def train_step(self, es, rb: Replay, obs):
        """One iteration: a collect phase with the actor, then
        ``grad_steps`` updates.  Returns ``(es, rb, obs, metrics)``."""
        es, rb, obs, (rewards, terms) = self.collect(es, rb, obs, uniform=False)
        c_losses, a_losses, q_means = zip(*(self.grad_update(rb) for _ in range(self.cfg.grad_steps)))
        metrics = torch.stack([
            torch.stack(c_losses).mean(), torch.stack(a_losses).mean(), torch.stack(q_means).mean(),
            rewards.mean(), terms.to(self.dtype).mean(),
        ])
        if self.mesh is not None:
            sharding.all_reduce_mean_(metrics, self.mesh)
        names = ("critic_loss", "actor_loss", "q_mean", "mean_reward", "terminated_frac")
        return es, rb, obs, dict(zip(names, metrics), alpha=torch.exp(self.log_alpha.detach()))

    # ------------------------------------------------------------------
    def init_envs(self):
        es, first = self.env.reset()
        return es, self.empty_replay(), first.obs

    def warmup(self, es, rb: Replay, obs):
        """Prefill the buffer with one collect phase of uniform actions."""
        es, rb, obs, _ = self.collect(es, rb, obs, uniform=True)
        return es, rb, obs

    def train(self, iterations: int, warmup_rounds: int = 2, log_every: int = 1):
        """``warmup_rounds`` uniform collect phases, then ``iterations``
        train steps; the metrics of every ``log_every``-th as floats."""
        es, rb, obs = self.init_envs()
        for _ in range(warmup_rounds):
            es, rb, obs = self.warmup(es, rb, obs)
        history = []
        for it in range(iterations):
            es, rb, obs, metrics = self.train_step(es, rb, obs)
            if it % log_every == 0:
                history.append({k: float(v) for k, v in metrics.items()})
        return history

    # ------------------------------------------------------------------
    def _tree(self):
        return {
            "actor": self.actor.state_dict(), "critic": self.critic.state_dict(),
            "target": self.target.state_dict(), "log_alpha": self.log_alpha.detach(),
            "opt_actor": adam_state(self.opt_actor), "opt_critic": adam_state(self.opt_critic),
            "opt_alpha": adam_state(self.opt_alpha),
        }

    def save(self, path: str):
        """Checkpoint all learner state (weights, targets, optimisers,
        temperature) to ``path`` (``.npz``)."""
        save_pytree(path, self._tree())

    def load(self, path: str):
        """Restore a checkpoint written by :meth:`save`."""
        tree = load_pytree(path, self._tree())
        for name in ("actor", "critic", "target"):
            getattr(self, name).load_state_dict(tree[name])
        with torch.no_grad():
            self.log_alpha.copy_(tree["log_alpha"])
        for name in ("opt_actor", "opt_critic", "opt_alpha"):
            load_adam_state(getattr(self, name), tree[name])
