"""Domain randomization over grid parameters: heterogeneous env fleets.

The counterpart of ``gym_anm_tpu.envs.randomized``: a fleet of G grid
*variants* (same topology and device layout, different electrical
parameters), each variant driving L lockstep lanes.  Use cases: training
policies robust to line-impedance / rating uncertainty, and sensitivity
sweeps.

Each variant keeps its own :class:`~gym_anm_tpu_torch.core.env_core.EnvCore`
and with it its own device tables (the tree kernel's admittance table, the
dense solvers' Y-bus and flat-start Jacobian inverse, the fused kernel's
step tables), so a fleet step is G variant steps side by side, each a plain
:class:`~gym_anm_tpu_torch.envs.batched.BatchedEnv` step that launches its
path's kernel once (the JAX package likewise inlines the G variant programs
rather than vmapping over a traced spec).  Intended for small G (tens of
variants); lanes L provide the wide batch axis.

One ``torch.Generator`` is the fleet's source of randomness, threaded
through every variant's reset, internal variables, auto-reset pool and
draws in variant order, so no two variants share a draw.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..constants import BRANCH_H
from ..core.env_core import EnvCore, EnvState
from .batched import BatchedEnv, BatchedStep


def perturb_branches(
    network: dict,
    rng: np.random.Generator,
    r_sigma: float = 0.1,
    x_sigma: float = 0.1,
    b_sigma: float = 0.0,
    rate_sigma: float = 0.0,
) -> dict:
    """Return a copy of ``network`` with multiplicative lognormal jitter on
    branch series resistance/reactance (and optionally shunt susceptance and
    thermal rating).

    Zero entries stay zero (a branch with r=0 stays purely reactive), taps
    and phase shifts are untouched, and the perturbed dict goes through the
    same eager validation as any other network when a ``GridSpec`` is built
    from it.  The draws are the JAX package's, in its order, so the same
    ``rng`` seed gives the same networks in both packages.
    """
    net = copy.deepcopy(network)
    br = np.array(net["branch"], dtype=float)
    for col, sigma in (
        (BRANCH_H["BR_R"], r_sigma),
        (BRANCH_H["BR_X"], x_sigma),
        (BRANCH_H["BR_B"], b_sigma),
        (BRANCH_H["RATE"], rate_sigma),
    ):
        if sigma <= 0.0:
            continue
        factors = np.exp(rng.normal(0.0, sigma, size=br.shape[0]))
        finite = np.isfinite(br[:, col])
        br[finite, col] = br[finite, col] * factors[finite]
    net["branch"] = br
    return net


def _randomized_cores(make_core, nominal, n_variants, seed, include_nominal, sigmas, make_core_kw):
    rng = np.random.default_rng(seed)
    return [
        make_core(**make_core_kw) if g == 0 and include_nominal
        else make_core(network=perturb_branches(nominal, rng, **sigmas), **make_core_kw)
        for g in range(n_variants)
    ]


def randomized_anm6easy_cores(
    n_variants: int,
    seed: int = 0,
    r_sigma: float = 0.1,
    x_sigma: float = 0.1,
    b_sigma: float = 0.0,
    rate_sigma: float = 0.0,
    include_nominal: bool = True,
    **make_core_kw,
) -> list[EnvCore]:
    """Build G ANM6Easy cores over independently perturbed 6-bus networks.

    With ``include_nominal`` the first variant is the canonical network (so
    the nominal task is always in the training distribution).
    ``make_core_kw`` (``dtype``, ``device``, ``pf_method``, ``warm_start``,
    ...) goes to every variant's ``make_core``."""
    from .anm6.anm6_easy import make_core
    from .anm6.network import network as nominal

    sigmas = dict(r_sigma=r_sigma, x_sigma=x_sigma, b_sigma=b_sigma, rate_sigma=rate_sigma)
    return _randomized_cores(make_core, nominal, n_variants, seed, include_nominal, sigmas, make_core_kw)


def randomized_feeder33_cores(
    n_variants: int,
    seed: int = 0,
    r_sigma: float = 0.1,
    x_sigma: float = 0.1,
    b_sigma: float = 0.0,
    rate_sigma: float = 0.0,
    include_nominal: bool = True,
    **make_core_kw,
) -> list[EnvCore]:
    """Build G feeder33 cores over independently perturbed 33-bus networks.

    Same contract as :func:`randomized_anm6easy_cores`."""
    from .feeder33 import make_core
    from .feeder_networks import make_feeder_network

    sigmas = dict(r_sigma=r_sigma, x_sigma=x_sigma, b_sigma=b_sigma, rate_sigma=rate_sigma)
    return _randomized_cores(
        make_core, make_feeder_network(), n_variants, seed, include_nominal, sigmas, make_core_kw
    )


def _stack(outs) -> BatchedStep:
    """Per-variant step outputs stacked to ``[G, L, ...]``."""
    return BatchedStep(*(torch.stack([getattr(o, f) for o in outs]) for f in BatchedStep._fields))


def _flat(out: BatchedStep) -> BatchedStep:
    """``[G, L, ...]`` outputs as one ``[G * L, ...]`` batch."""
    return BatchedStep(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in out))


class MultiBatchedEnv:
    """G grid variants x L lockstep lanes.

    All cores must share action/observation sizes (same device layout) and
    one device.  Outputs carry a leading ``[G, L]`` pair of axes; the
    per-variant environment states are held as a G-tuple of
    :class:`~gym_anm_tpu_torch.core.env_core.EnvState` (each variant's
    tables are its own).  ``generator`` (default: one on the cores' device
    seeded with 0) draws every sample of every variant; ``auto_reset``
    re-initialises terminated lanes as :class:`BatchedEnv` does.
    """

    def __init__(
        self,
        cores: Sequence[EnvCore],
        lanes_per_variant: int,
        auto_reset: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        if not cores:
            raise ValueError("need at least one variant core")
        c0 = cores[0]
        for c in cores[1:]:
            if c.action_n != c0.action_n or c.obs_n != c0.obs_n:
                raise ValueError("all variant cores must share action/observation sizes")
            if c.device != c0.device:
                raise ValueError("all variant cores must be on one device")
        self.cores = list(cores)
        self.G = len(self.cores)
        self.L = int(lanes_per_variant)
        self.device, self.dtype = c0.device, c0.dtype
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.auto_reset = bool(auto_reset)
        self.auto_reset_mode = "pool"
        self.envs = [BatchedEnv(c, self.L, generator=generator, auto_reset=auto_reset) for c in self.cores]
        self.action_n = c0.action_n
        self.obs_n = c0.obs_n
        self._action_low = torch.as_tensor(c0.action_low, device=self.device).to(self.dtype)
        self._action_high = torch.as_tensor(c0.action_high, device=self.device).to(self.dtype)

    # ------------------------------------------------------------------
    def reset(self) -> tuple[tuple[EnvState, ...], BatchedStep]:
        """Reset every variant's lanes (:meth:`BatchedEnv.reset`, each
        variant after the other on the fleet's generator): ``(states,
        BatchedStep [G, L, ...])``, ``terminated`` marking lanes whose reset
        attempts all failed."""
        states, outs = zip(*(env.reset() for env in self.envs))
        return states, _stack(outs)

    def fresh_states(self, generator: Optional[torch.Generator] = None) -> tuple[EnvState, ...]:
        """Per-variant tuple of auto-reset pools (one B=L pool per variant);
        see :meth:`BatchedEnv.fresh_states`."""
        gen = self.generator if generator is None else generator
        return tuple(env.fresh_states(gen) for env in self.envs)

    def step_fn(self, states, actions, generator: Optional[torch.Generator] = None, fresh=None):
        """One fleet step: ``actions [G, L, action_n]``; each variant's
        internal variables (and, with ``auto_reset``, its rebirths from
        ``fresh[g]`` or a single-attempt reset) are drawn from the
        generator in variant order.  Returns ``(states, BatchedStep [G, L,
        ...])``."""
        gen = self.generator if generator is None else generator
        new_states, outs = [], []
        for g, env in enumerate(self.envs):
            es, out = env.step_fn(states[g], actions[g], gen, fresh=None if fresh is None else fresh[g])
            new_states.append(es)
            outs.append(out)
        return tuple(new_states), _stack(outs)

    def step(self, states, actions, generator: Optional[torch.Generator] = None):
        """One fleet step (:meth:`step_fn` without a pool)."""
        return self.step_fn(states, actions, generator)

    def flat_reset(self):
        """:meth:`reset` with outputs flattened to one ``[G * L, ...]`` batch
        (states stay a G-tuple: the carry trainers thread through
        unchanged)."""
        states, out = self.reset()
        return states, _flat(out)

    def flat_step_fn(self, states, actions, generator: Optional[torch.Generator] = None, fresh=None):
        """:meth:`step_fn` taking and returning flat ``[G * L, ...]``
        tensors: the :class:`BatchedEnv`-shaped surface trainers expect."""
        states, out = self.step_fn(states, actions.reshape(self.G, self.L, -1), generator, fresh=fresh)
        return states, _flat(out)

    def observation(self, states) -> torch.Tensor:
        """Per-variant observations stacked to ``[G, L, obs_n]``."""
        return torch.stack([core.observation(es) for core, es in zip(self.cores, states)])

    def flat_observation(self, states) -> torch.Tensor:
        """Per-variant observations concatenated to ``[G * L, obs_n]``."""
        return torch.cat([core.observation(es) for core, es in zip(self.cores, states)])

    def random_actions(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Uniform actions over the action space, ``[G, L, action_n]``."""
        gen = self.generator if generator is None else generator
        u = torch.rand((self.G, self.L, self.action_n), generator=gen, device=self.device, dtype=self.dtype)
        return u * (self._action_high - self._action_low) + self._action_low

    def rollout(self, states, n_steps: int, policy_fn: Optional[Callable] = None, policy_args=None):
        """``n_steps`` fleet steps.

        ``policy_fn(policy_args, obs [G, L, obs_n], generator) -> [G, L,
        action_n]`` sees the whole heterogeneous fleet at once (one policy
        across all variants: the domain-randomization training setup); None
        draws uniform random actions.  Each step goes through
        :meth:`step_fn` without a pool, as the JAX package's ``rollout_fn``
        does: with ``auto_reset``, terminated lanes are reborn from a
        single-attempt reset every step (only the trainers pass a pool).
        Returns ``(states, (reward [T, G, L], terminated [T, G, L]))``, or
        ``(states, (obs [T, G, L, obs_n], actions [T, G, L, action_n],
        reward, terminated))`` with a policy.
        """
        ys = []
        for _ in range(int(n_steps)):
            if policy_fn is None:
                obs, actions = None, self.random_actions()
            else:
                obs = self.observation(states)
                actions = policy_fn(policy_args, obs, self.generator)
            states, out = self.step_fn(states, actions)
            ys.append((out.reward, out.terminated) if policy_fn is None else (obs, actions, out.reward, out.terminated))
        return states, tuple(torch.stack(y) for y in zip(*ys))


class _FleetCoreFacade:
    """The part of the :class:`EnvCore` surface a trainer reads, over a
    fleet: the device, dtype, action bounds and observation gather of
    variant 0 (variants share their device layout), and flat observations
    across all variants (the carry is the G-tuple of per-variant states)."""

    def __init__(self, multi: MultiBatchedEnv):
        c0 = multi.cores[0]
        self.device, self.dtype = c0.device, c0.dtype
        self.action_low = c0.action_low
        self.action_high = c0.action_high
        self.action_n = c0.action_n
        self.obs_gather = c0.obs_gather
        self._multi = multi

    def observation(self, states):
        return self._multi.flat_observation(states)


class _FleetEnvFacade:
    """The env surface a trainer drives: ``reset`` / ``fresh_states`` /
    ``step_fn`` over flat ``[G * L, ...]`` batches, with pool auto-reset."""

    def __init__(self, multi: MultiBatchedEnv):
        self._multi = multi
        self.auto_reset = multi.auto_reset
        self.auto_reset_mode = multi.auto_reset_mode

    def reset(self):
        return self._multi.flat_reset()

    def fresh_states(self, generator=None):
        return self._multi.fresh_states(generator)

    def step_fn(self, states, actions, generator=None, fresh=None):
        return self._multi.flat_step_fn(states, actions, generator, fresh=fresh)


def _fleet_trainer(trainer_cls, cores, lanes_per_variant, config, seed, generator):
    device = cores[0].device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    multi = MultiBatchedEnv(cores, lanes_per_variant, auto_reset=True, generator=generator)
    return trainer_cls(
        _FleetCoreFacade(multi), batch_size=multi.G * multi.L, config=config, seed=seed,
        env=_FleetEnvFacade(multi), generator=generator,
    )


def ppo_trainer_for_fleet(
    cores: Sequence[EnvCore], lanes_per_variant: int, config=None, seed: int = 0,
    generator: Optional[torch.Generator] = None,
):
    """Build a :class:`~gym_anm_tpu_torch.rl.ppo.PPOTrainer` whose rollouts
    step a domain-randomized fleet: one policy trained against G grid
    variants at once (batch = G * lanes_per_variant).  Terminated lanes
    auto-reset from a pool to keep the fleet lockstep.  ``generator``
    (default: one on the cores' device seeded with ``seed``) draws every
    sample of the trainer and the fleet."""
    from ..rl.ppo import PPOTrainer

    return _fleet_trainer(PPOTrainer, cores, lanes_per_variant, config, seed, generator)


def sac_trainer_for_fleet(
    cores: Sequence[EnvCore], lanes_per_variant: int, config=None, seed: int = 0,
    generator: Optional[torch.Generator] = None,
):
    """Build a :class:`~gym_anm_tpu_torch.rl.sac.SACTrainer` whose collect
    phase steps a domain-randomized fleet (replay transitions mix all G
    variants, so the learned Q-function averages over grid-parameter
    uncertainty).  ``generator`` as for :func:`ppo_trainer_for_fleet`."""
    from ..rl.sac import SACTrainer

    return _fleet_trainer(SACTrainer, cores, lanes_per_variant, config, seed, generator)
