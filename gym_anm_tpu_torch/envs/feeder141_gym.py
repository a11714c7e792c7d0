"""The ``ANMFeeder141-v0`` Gymnasium environment.

The counterpart of ``gym_anm_tpu.envs.feeder141.Feeder141Env``: a
:class:`~gym_anm_tpu_torch.envs.feeder33_gym.Feeder33Env` on the 141-bus
multi-trunk network.  :mod:`.feeder141` imports no Gymnasium and
re-exports this class.

This module imports Gymnasium.
"""

from __future__ import annotations

import torch

from .feeder33_gym import Feeder33Env
from .feeder_networks import make_multi_feeder_network


class Feeder141Env(Feeder33Env):
    """Gymnasium environment on the 141-bus multi-trunk network (same
    stochastic load/renewable dynamics as the 33-bus feeder), computing on
    ``device`` (the card unless the caller passes ``"cpu"``) in ``dtype``."""

    def __init__(self, seed=None, device="cuda", dtype=torch.float64):
        super().__init__(seed=seed, network=make_multi_feeder_network(), device=device, dtype=dtype)
