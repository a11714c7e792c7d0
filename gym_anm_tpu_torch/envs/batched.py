"""Batched lockstep environments on one device.

The counterpart of ``gym_anm_tpu.envs.batched.BatchedEnv``: an
:class:`~gym_anm_tpu_torch.core.env_core.EnvCore` steps a whole ``[B, ...]``
batch of environments at once; on a CUDA device the power flow of every
lane (or, on the fused paths, the whole transition) runs in the kernel of
the core's ``pf_method``.  Terminated lanes stay in the absorbing
zero state (the reference's semantics, anm_env.py:365-367); auto-reset is
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.env_core import EnvCore, EnvState


class BatchedStep(NamedTuple):
    obs: torch.Tensor  # [B, obs_n]
    reward: torch.Tensor  # [B]
    terminated: torch.Tensor  # [B] bool
    state_vec: torch.Tensor  # [B, state_n]


class BatchedEnv:
    """``batch_size`` lockstep environments of ``core``.

    ``device`` defaults to the core's device (and must equal it);
    ``generator`` is the source of all randomness (initial states, the
    task's internal variables, the uniform actions of :meth:`rollout`) and
    defaults to a generator on that device seeded with 0.
    """

    def __init__(
        self,
        core: EnvCore,
        batch_size: int,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        self.core = core
        self.batch_size = int(batch_size)
        self.device = core.device if device is None else torch.device(device)
        if self.device != core.device:
            raise ValueError("BatchedEnv device %s differs from the core's %s" % (self.device, core.device))
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self._action_low = torch.as_tensor(core.action_low, device=self.device).to(core.dtype)
        self._action_high = torch.as_tensor(core.action_high, device=self.device).to(core.dtype)

    def reset(self) -> tuple[EnvState, BatchedStep]:
        """Reset all lanes (the task's rejection-sampling budget).  A lane
        whose attempts all fail comes back terminated."""
        es, out = self.core.reset(self.generator, self.batch_size)
        zero = torch.zeros((self.batch_size,), dtype=self.core.dtype, device=self.device)
        return es, BatchedStep(obs=out.obs, reward=zero, terminated=out.failed, state_vec=out.state_vec)

    def step(self, es: EnvState, actions) -> tuple[EnvState, BatchedStep]:
        """One batched step: ``actions [B, action_n]`` in MW/MVAr; the
        internal variables come from the task's ``next_vars_fn``."""
        es, out = self.core.step_with_generator(es, actions, self.generator)
        return es, BatchedStep(obs=out.obs, reward=out.reward, terminated=out.terminated, state_vec=out.state_vec)

    def random_actions(self) -> torch.Tensor:
        """Uniform actions over the action space, ``[B, action_n]``."""
        u = torch.rand(
            (self.batch_size, self.core.action_n), generator=self.generator, device=self.device, dtype=self.core.dtype
        )
        return u * (self._action_high - self._action_low) + self._action_low

    def rollout(self, es: EnvState, n_steps: int):
        """``n_steps`` steps with uniform random actions.

        Returns ``(es, (reward [T, B], terminated [T, B]))``."""
        rewards, terms = [], []
        for _ in range(int(n_steps)):
            es, out = self.step(es, self.random_actions())
            rewards.append(out.reward)
            terms.append(out.terminated)
        return es, (torch.stack(rewards), torch.stack(terms))
