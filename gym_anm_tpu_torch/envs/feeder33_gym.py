"""The ``ANMFeeder33-v0`` Gymnasium environment.

The counterpart of ``gym_anm_tpu.envs.feeder33.Feeder33Env``: the 33-bus
synthetic radial feeder with stochastic loads around a daily profile and
stochastic renewable potentials, whose host hooks draw from the Gymnasium
``np_random`` generator in the JAX package's call order.  The tensor hooks
and ``make_core`` of the batched path stay in :mod:`.feeder33`, which
imports no Gymnasium and re-exports this class.

This module imports Gymnasium.
"""

from __future__ import annotations

import numpy as np
import torch

from .anm_env import ANMEnv
from .feeder_networks import make_feeder_network


class Feeder33Env(ANMEnv):
    """Gymnasium environment on the 33-bus feeder with stochastic loads
    (mean-reverting noise around a daily profile) and renewable potentials,
    computing on ``device`` (the card unless the caller passes ``"cpu"``)
    in ``dtype``.  ``network`` replaces the 33-bus feeder with another
    network dict under the same dynamics."""

    def __init__(self, seed=None, network=None, device="cuda", dtype=torch.float64):
        observation = "state"
        K = 1
        delta_t = 0.25
        gamma = 0.995
        lamb = 100
        aux_bounds = np.array([[0, 95]])
        costs_clipping = (1, 100)
        net = make_feeder_network() if network is None else network
        super().__init__(net, observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping, seed,
                         device=device, dtype=dtype)
        spec = self.simulator.spec
        self._load_scale = -np.asarray(spec.load_p_min) * spec.baseMVA
        self._pv_scale = np.asarray(spec.gen_p_max) * spec.baseMVA

    def init_state(self):
        spec = self.simulator.spec
        n_dev, n_des, n_gen = spec.n_dev, spec.n_des, spec.n_gen
        state = np.zeros(2 * n_dev + n_des + n_gen + self.K)
        t0 = self.np_random.integers(0, 96)
        state[-1] = t0
        frac = _daily_factor(t0)
        loads = -self._load_scale * frac * self.np_random.uniform(0.3, 0.9, spec.n_load)
        pos = np.asarray(spec.load_pos)
        state[pos] = loads
        state[n_dev + pos] = loads * np.asarray(spec.load_qp)
        pots = self._pv_scale * self.np_random.uniform(0.2, 1.0, n_gen)
        state[np.asarray(spec.gen_pos)] = pots
        state[2 * n_dev + n_des :][:n_gen] = pots
        state[2 * n_dev : 2 * n_dev + n_des] = self.np_random.uniform(
            0, np.asarray(spec.des_soc_max) * spec.baseMVA
        )
        return state

    def next_vars(self, s_t):
        spec = self.simulator.spec
        aux = int((s_t[-1] + 1) % 96)
        frac = _daily_factor(aux)
        loads = -self._load_scale * frac * self.np_random.uniform(0.3, 0.9, spec.n_load)
        pots = self._pv_scale * self.np_random.uniform(0.2, 1.0, spec.n_gen)
        return np.concatenate([loads, pots, [aux]])


def _daily_factor(t):
    """Smooth daily demand factor in [0.5, 1] peaking in the evening."""
    return 0.75 + 0.25 * np.sin(2 * np.pi * (np.asarray(t, dtype=float) / 96.0 - 0.3))
