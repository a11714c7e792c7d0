"""The 6-bus, 7-device environment base class.

The counterpart of ``gym_anm_tpu.envs.anm6.anm6.ANM6`` (reference
``envs/anm6_env/anm6.py:13-239``): the fixed 6-bus network.  The render
lifecycle and the simulated date clock live in
:class:`~gym_anm_tpu_torch.envs.anm_env.ANMEnv` itself, leaving this class
as just the network binding.

This module imports Gymnasium.
"""

from __future__ import annotations

import torch

from ..anm_env import ANMEnv
from .network import network


class ANM6(ANMEnv):
    """Base class for 6-bus 7-device environments (rendering-capable).

    Network topology::

        Slack ----------------------------
                |            |           |
              -----       -------      -----
             |     |     |       |    |     |
            House  PV  Factory  Wind  EV   DES
    """

    def __init__(self, observation, K, delta_t, gamma, lamb, aux_bounds=None, costs_clipping=(None, None), seed=None,
                 device="cuda", dtype=torch.float64):
        super().__init__(network, observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping, seed,
                         device=device, dtype=dtype)
