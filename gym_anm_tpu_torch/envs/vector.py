"""Gymnasium ``VectorEnv`` adapter over the batched environment core.

The counterpart of ``gym_anm_tpu.envs.vector.ANMVectorEnv``: the standard
``gymnasium.vector.VectorEnv`` interface (Stable-Baselines3, CleanRL, ...)
over :class:`~gym_anm_tpu_torch.envs.vector_core.LockstepEnv`, which steps
all ``num_envs`` environments in lockstep on the core's device, with
Gymnasium's next-step autoreset (``AutoresetMode.NEXT_STEP``).  On a core
of ``make_core`` (``pf_method="tree"``) each step runs the tree-NR kernel
twice on the card: the step and the fresh states.

This module imports Gymnasium; :mod:`.vector_core` does not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import gymnasium
import torch
from gymnasium.vector import VectorEnv
from gymnasium.vector.utils import batch_space

from ..core.env_core import EnvCore
from .vector_core import LockstepEnv, to_numpy


class ANMVectorEnv(VectorEnv):
    """Lockstep-on-the-device ``gymnasium.vector.VectorEnv``.

    Parameters
    ----------
    core : EnvCore
        Environment core with the task hooks (e.g.
        ``gym_anm_tpu_torch.envs.anm6.anm6_easy.make_core()``); the
        environments run on its device, in its dtype.
    num_envs : int
        Number of lockstep environments.
    seed : int, optional
        Initial seed of the generator (can also be passed to :meth:`reset`).
    reset_attempts : int | None
        Rejection-sampling rounds of a full reset (None: the task's
        ``core.reset_attempts``; an autoreset takes one attempt).
    """

    metadata = {"autoreset_mode": gymnasium.vector.AutoresetMode.NEXT_STEP}

    def __init__(
        self, core: EnvCore, num_envs: int, seed: Optional[int] = None, reset_attempts: Optional[int] = None
    ):
        super().__init__()
        self._lockstep = LockstepEnv(core, num_envs, seed=seed, reset_attempts=reset_attempts)
        self.core = core
        self.num_envs = int(num_envs)
        self.render_mode = None
        f = np.float32 if core.dtype == torch.float32 else np.float64

        self.single_action_space = gymnasium.spaces.Box(
            low=np.asarray(core.action_low, dtype=f), high=np.asarray(core.action_high, dtype=f), dtype=f
        )
        self.single_observation_space = gymnasium.spaces.Box(
            low=np.asarray(core.obs_gather.low, dtype=f), high=np.asarray(core.obs_gather.high, dtype=f), dtype=f
        )
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        obs, failed = self._lockstep.reset(seed=seed)
        # A lane that exhausted the rejection-sampling budget is terminated
        # (absorbing zero state) and flagged for autoreset: it retries a
        # fresh initial state on the next step.
        host = torch.cat([obs, failed[:, None].to(obs.dtype)], dim=1).cpu().numpy()
        return host[:, :-1], {"reset_failed": host[:, -1] > 0.5}

    def step(self, actions):
        obs, reward, terminated = to_numpy(self._lockstep.step(np.asarray(actions)))
        truncated = np.zeros((self.num_envs,), dtype=bool)
        return obs, reward, terminated, truncated, {}

    def close_extras(self, **kwargs):
        lockstep = getattr(self, "_lockstep", None)  # None when the constructor raised
        if lockstep is not None:
            lockstep.es = None
