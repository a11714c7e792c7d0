"""PPO trainer over batched ANM environments on one device.

The counterpart of ``gym_anm_tpu.rl.ppo``: rollouts are stepped through
:class:`~gym_anm_tpu_torch.envs.batched.BatchedEnv` with pool auto-reset,
advantages come from a reverse GAE pass, and updates are minibatched
clipped-PPO epochs, on one device or data-parallel over a mesh of ranks
(``mesh=``, :mod:`gym_anm_tpu_torch.parallel`), with the torso split over
the mesh's ``tp`` dimension when it has one.  The model is a
tanh-squashed diagonal-Gaussian actor and a value critic on a shared tanh
MLP, with observations normalised by the observation bounds and actions
mapped affinely onto [action_low, action_high].  The optimiser is ``optax.chain(clip_by_global_norm, adam)``
as the JAX package has it.  The products of the MLP are plain
``nn.Linear`` layers: the JAX package computes them outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..checkpoint import load_pytree, save_pytree
from ..envs.batched import BatchedEnv
from ..parallel import sharding
from ..parallel.tensor import ColumnParallelLinear, RowParallelLinear
from ._nn import (
    adam_state, clip_by_global_norm_, dense, flax_dense, load_adam_state, obs_norm_tables, squashed_logp,
)

LOG_2PI_E = float(np.log(2 * np.pi * np.e))


class ActorCritic(nn.Module):
    """MLP actor-critic with a Gaussian policy head: ``hidden`` tanh layers,
    a mean head, a state-independent ``log_std`` (initialised to -0.5) and a
    value head.

    On a ``mesh`` whose tp width is above 1, the first hidden layer is
    column-parallel and the second row-parallel over the tp group
    (:mod:`gym_anm_tpu_torch.parallel.tensor`, the layout of
    ``__graft_entry__.py::_param_shardings``); the heads, ``log_std`` and any
    further layer are replicated.  The layers are drawn in full and sliced,
    so the sharded model holds the unsharded model's numbers."""

    def __init__(self, obs_n: int, action_n: int, hidden=(256, 256), generator: Optional[torch.Generator] = None,
                 mesh=None):
        super().__init__()
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        sizes = (obs_n,) + tuple(hidden)
        self.torso = nn.ModuleList(dense(a, b, gen) for a, b in zip(sizes[:-1], sizes[1:]))
        self.mean = dense(sizes[-1], action_n, gen)
        self.log_std = nn.Parameter(torch.full((action_n,), -0.5))
        self.value = dense(sizes[-1], 1, gen)
        self.tp_group = None
        tp = 1 if mesh is None else sharding.tp_size(mesh)
        if tp > 1:
            if len(hidden) < 2:
                raise ValueError("the tp layout splits two hidden layers: hidden=%s" % (tuple(hidden),))
            rank, self.tp_group = sharding.tp_rank(mesh), sharding.tp_group(mesh)
            self.torso[0] = ColumnParallelLinear(self.torso[0], tp, rank, self.tp_group)
            self.torso[1] = RowParallelLinear(self.torso[1], tp, rank, self.tp_group)

    def sharded_parameters(self) -> list:
        """This rank's shards of the tp-split parameters (none without tp)."""
        if self.tp_group is None:
            return []
        return [self.torso[0].weight, self.torso[0].bias, self.torso[1].weight]

    def forward(self, obs):
        x = obs
        for layer in self.torso:
            x = torch.tanh(layer(x))
        return self.mean(x), self.log_std, self.value(x)[..., 0]


def params_from_flax(params_np, hidden, tp: int = 1, tp_rank: int = 0) -> dict:
    """The :class:`ActorCritic` ``state_dict`` holding the weights of the
    JAX package's flax ``ActorCritic`` (its ``{"params": {...}}`` tree as
    NumPy arrays): ``Dense_i`` for the hidden layers, then the mean head,
    then the value head; a Dense ``kernel [in, out]`` becomes a ``weight
    [out, in]``.  With ``tp > 1``, the shards of tp rank ``tp_rank`` as
    ``__graft_entry__.py::_param_shardings`` lays them out: ``Dense_0``'s
    kernel columns and bias (``P(None, "tp")``, ``P("tp")``) and
    ``Dense_1``'s kernel rows (``P("tp", None)``)."""
    p = params_np["params"]
    h = len(hidden)
    out = {"log_std": torch.as_tensor(np.asarray(p["log_std"]).copy())}
    for i in range(h):
        out.update(flax_dense("torso.%d" % i, p["Dense_%d" % i]))
    out.update(flax_dense("mean", p["Dense_%d" % h]))
    out.update(flax_dense("value", p["Dense_%d" % (h + 1)]))
    return tp_shard_state_dict(out, hidden, tp, tp_rank) if tp > 1 else out


def tp_shard_state_dict(state: dict, hidden, tp: int, tp_rank: int) -> dict:
    """An unsharded :class:`ActorCritic` ``state_dict`` cut to the shards of
    tp rank ``tp_rank`` (the rest shared as is): ``torso.0``'s rows of its
    weight and bias, ``torso.1``'s columns of its weight."""
    k = hidden[0] // tp  # torso.0's outputs are torso.1's inputs
    mine = slice(tp_rank * k, (tp_rank + 1) * k)
    out = dict(state)
    out["torso.0.weight"] = state["torso.0.weight"][mine].clone()
    out["torso.0.bias"] = state["torso.0.bias"][mine].clone()
    out["torso.1.weight"] = state["torso.1.weight"][:, mine].clone()
    return out


@dataclasses.dataclass
class PPOConfig:
    rollout_steps: int = 64
    minibatches: int = 8
    epochs: int = 4
    gamma: float = 0.995
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: tuple = (256, 256)
    # Rewards are scaled before GAE/returns: ANM terminal rewards are
    # -c2/(1-gamma) (e.g. -20000), which otherwise dominates the value loss.
    reward_scale: float = 0.05


class Transition(NamedTuple):
    obs: torch.Tensor
    action_u: torch.Tensor  # pre-squash action in [-1, 1] space
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor


def gae(cfg: PPOConfig, traj: Transition, last_value):
    """Advantages and returns ``[T, B]`` by the reverse GAE recursion."""
    advs = []
    adv, v_next = torch.zeros_like(last_value), last_value
    for t in range(traj.reward.shape[0] - 1, -1, -1):
        nonterm = 1.0 - traj.terminated[t].to(traj.value.dtype)
        delta = cfg.reward_scale * traj.reward[t] + cfg.gamma * v_next * nonterm - traj.value[t]
        adv = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv
        v_next = traj.value[t]
        advs.append(adv)
    advs = torch.stack(advs[::-1])
    return advs, advs + traj.value


class PPOTrainer:
    """Clipped PPO over a :class:`BatchedEnv` with pool auto-reset.

    ``env`` (optional) replaces the default ``BatchedEnv(core, batch_size,
    auto_reset=True)``: any object with ``reset()`` and ``step_fn(es,
    actions [B, A], generator, fresh=None)`` over flat ``[B, ...]``
    outputs.  ``generator`` (default: one on the core's device seeded with
    ``seed``) draws every sample of the trainer and its default env; the
    weights are initialised from ``seed``.

    ``mesh`` (a :func:`~gym_anm_tpu_torch.parallel.sharding.make_mesh`)
    trains data-parallel, one rank a card, the core on the rank's device:
    ``batch_size`` is global and each dp coordinate steps ``batch_size /
    dp`` lanes (``self.B``) with its own generator, seeded from ``(seed, dp
    rank)``.  The parameters are broadcast from dp coordinate 0 at
    construction (Adam's state is still empty then); every update averages
    the gradients over the dp group before the clip and Adam, and
    normalizes advantages with the global minibatch's mean and standard
    deviation, so a dp update equals the one-device update on the union of
    the ranks' minibatches.  On a ``dp x tp`` mesh the model's torso is
    split over tp (:class:`ActorCritic`), the ranks of one dp coordinate
    step the same lanes, and the clip's norm sums the shards' squares over
    the tp group.  Metrics are means over the dp coordinates.
    """

    def __init__(self, core, batch_size: int, config: Optional[PPOConfig] = None, seed: int = 0, env=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        self.cfg = config or PPOConfig()
        self.core = core
        self.mesh = mesh
        world = 1 if mesh is None else sharding.dp_size(mesh)
        if int(batch_size) % world:
            raise ValueError("batch_size %d does not split evenly over %d ranks" % (batch_size, world))
        self.B = int(batch_size) // world
        self.device, self.dtype = core.device, core.dtype
        if generator is None:
            rank_seed = seed if mesh is None else sharding.rank_seed(seed, sharding.dp_rank(mesh))
            generator = torch.Generator(device=self.device).manual_seed(rank_seed)
        self.generator = generator
        self.env = env if env is not None else BatchedEnv(core, self.B, generator=generator, auto_reset=True)
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)
        self.lo, self.hi = t(core.action_low), t(core.action_high)
        self.obs_centre, self.obs_scale = obs_norm_tables(core, self.dtype, self.device)
        self.model = ActorCritic(
            core.obs_gather.n, core.action_n, self.cfg.hidden, torch.Generator().manual_seed(seed), mesh
        ).to(self.device, self.dtype)
        if mesh is not None:
            sharding.broadcast_params_([self.model], mesh)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=self.cfg.lr, eps=1e-8)

    # ------------------------------------------------------------------
    def _norm_obs(self, obs):
        return (obs - self.obs_centre) / self.obs_scale

    def _to_env_action(self, u):
        """Map a squashed action u in [-1, 1] to the env's MW/MVAr box."""
        return self.lo + (u + 1.0) * 0.5 * (self.hi - self.lo)

    def _policy_sample(self, obs):
        """``(u, logp, value)``: an action ``u = tanh(mean + std eps)``, ``eps``
        standard normal from the trainer's generator."""
        mean, log_std, value = self.model(self._norm_obs(obs))
        eps = torch.randn(mean.shape, generator=self.generator, device=self.device, dtype=mean.dtype)
        u = torch.tanh(mean + torch.exp(log_std) * eps)
        return u, squashed_logp(eps, log_std, u), value

    def _policy_logp(self, obs, u):
        """``(logp, entropy, value)`` of the squashed actions ``u`` (the
        entropy of the pre-squash Gaussian, one value for every lane)."""
        mean, log_std, value = self.model(self._norm_obs(obs))
        pre = torch.atanh(torch.clamp(u, -1 + 1e-6, 1 - 1e-6))
        eps = (pre - mean) / torch.exp(log_std)
        entropy = torch.sum(log_std + 0.5 * LOG_2PI_E, dim=-1)
        return squashed_logp(eps, log_std, u), entropy, value

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, es):
        """``rollout_steps`` policy steps from ``es``: ``(es, traj,
        last_value)``.  With a pool auto-reset env, one pool of fresh states
        serves the whole rollout."""
        env, core = self.env, self.core
        use_pool = getattr(env, "auto_reset", False) and getattr(env, "auto_reset_mode", "step") == "pool" \
            and hasattr(env, "fresh_states")
        fresh = env.fresh_states(self.generator) if use_pool else None
        steps = []
        for _ in range(self.cfg.rollout_steps):
            obs = core.observation(es)
            u, logp, value = self._policy_sample(obs)
            es, out = env.step_fn(es, self._to_env_action(u), self.generator, fresh=fresh)
            steps.append(Transition(obs, u, logp, value, out.reward, out.terminated))
        traj = Transition(*(torch.stack(x) for x in zip(*steps)))
        last_value = self.model(self._norm_obs(core.observation(es)))[2]
        return es, traj, last_value

    def loss(self, batch):
        """The clipped PPO loss of a minibatch ``(obs, u, logp_old, adv,
        ret)``: ``(loss, (pg, vf, entropy))``."""
        cfg = self.cfg
        obs, u, logp_old, adv, ret = batch
        logp, entropy, value = self._policy_logp(obs, u)
        ratio = torch.exp(logp - logp_old)
        mean, std = self._adv_stats(adv)
        adv_n = (adv - mean) / (std + 1e-8)
        pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n).mean()
        vf = 0.5 * torch.mean((value - ret) ** 2)
        ent = entropy.mean()
        return pg + cfg.vf_coef * vf - cfg.ent_coef * ent, (pg, vf, ent)

    def _adv_stats(self, adv):
        """The minibatch's advantage mean and (population) standard
        deviation; with a mesh, over the union of the ranks' minibatches
        (equal sizes), in two passes as on one device."""
        if self.mesh is None:
            return adv.mean(), adv.std(correction=0)
        mean = sharding.all_reduce_mean_(adv.mean(), self.mesh)
        var = sharding.all_reduce_mean_(torch.mean((adv - mean) ** 2), self.mesh)
        return mean, torch.sqrt(var)

    def update(self, batch):
        """One optimiser step on a minibatch: the loss's gradient (averaged
        over the dp coordinates with a mesh), clipped by the whole model's
        global norm, then Adam.  Returns the loss (before the step)."""
        self.opt.zero_grad(set_to_none=True)
        loss, _ = self.loss(batch)
        loss.backward()
        if self.mesh is not None:
            sharding.average_grads_(list(self.model.parameters()), self.mesh)
        clip_by_global_norm_(list(self.model.parameters()), self.cfg.max_grad_norm,
                             self.model.sharded_parameters(), self.model.tp_group)
        self.opt.step()
        return loss.detach()

    def train_step(self, es):
        """One iteration: a rollout, GAE and ``epochs`` passes of
        ``minibatches`` updates over a fresh permutation each.  Returns
        ``(es, metrics)`` with tensor metrics."""
        cfg = self.cfg
        es, traj, last_value = self.rollout(es)
        advs, rets = gae(cfg, traj, last_value)
        T = cfg.rollout_steps
        flat = lambda x: x.reshape((T * self.B,) + tuple(x.shape[2:]))
        data = (flat(traj.obs), flat(traj.action_u), flat(traj.log_prob), flat(advs), flat(rets))
        n = T * self.B
        mb = n // cfg.minibatches
        losses = []
        for _ in range(cfg.epochs):
            perm = torch.randperm(n, generator=self.generator, device=self.device)
            for idx in perm[: mb * cfg.minibatches].reshape(cfg.minibatches, mb):
                losses.append(self.update(tuple(d[idx] for d in data)))
        metrics = torch.stack(
            [torch.stack(losses).mean(), traj.reward.mean(), traj.terminated.to(self.dtype).mean()]
        )
        if self.mesh is not None:
            sharding.all_reduce_mean_(metrics, self.mesh)
        return es, dict(zip(("loss", "mean_reward", "terminated_frac"), metrics))

    # ------------------------------------------------------------------
    def init_envs(self):
        es, _ = self.env.reset()
        return es

    def train(self, iterations: int, log_every: int = 1):
        """``iterations`` train steps from a reset; the metrics of every
        ``log_every``-th as floats."""
        es = self.init_envs()
        history = []
        for it in range(iterations):
            es, metrics = self.train_step(es)
            if it % log_every == 0:
                history.append({k: float(v) for k, v in metrics.items()})
        return history

    # ------------------------------------------------------------------
    def _tree(self):
        return {"params": self.model.state_dict(), "opt_state": adam_state(self.opt)}

    def save(self, path: str):
        """Checkpoint the weights and the optimiser state to ``path``
        (``.npz``, :func:`~gym_anm_tpu_torch.checkpoint.save_pytree`)."""
        save_pytree(path, self._tree())

    def load(self, path: str):
        """Restore a checkpoint written by :meth:`save`."""
        tree = load_pytree(path, self._tree())
        self.model.load_state_dict(tree["params"])
        load_adam_state(self.opt, tree["opt_state"])
