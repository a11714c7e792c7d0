"""The ``ANMBaranWu33-v0`` Gymnasium environment.

A :class:`~gym_anm_tpu_torch.envs.feeder33_gym.Feeder33Env` on Baran and
Wu's 33-bus feeder.  :mod:`.baranwu33` imports no Gymnasium and re-exports
this class.

This module imports Gymnasium.
"""

from __future__ import annotations

import torch

from .feeder33_gym import Feeder33Env
from .feeder_networks import make_baran_wu_33_network


class Baranwu33Env(Feeder33Env):
    """Gymnasium environment on Baran and Wu's 33-bus feeder (the 33-bus
    feeder task's stochastic load and renewable dynamics), computing on
    ``device`` (the card unless the caller passes ``"cpu"``) in ``dtype``."""

    def __init__(self, seed=None, device="cuda", dtype=torch.float64):
        super().__init__(seed=seed, network=make_baran_wu_33_network(), device=device, dtype=dtype)
