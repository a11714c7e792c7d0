"""The ``ANM6Easy-v0`` Gymnasium environment (reference
``envs/anm6_env/anm6_easy.py``).

The counterpart of the ``ANM6Easy`` class of
``gym_anm_tpu.envs.anm6.anm6_easy``: the host hooks ``init_state`` /
``next_vars`` draw from the Gymnasium ``np_random`` generator in the
reference's call order, and ``reset`` advances the date clock to the
sampled time of day.  The tensor hooks and ``make_core`` of the batched
path stay in :mod:`.anm6_easy`, which imports no Gymnasium and re-exports
this class.

This module imports Gymnasium.
"""

from __future__ import annotations

import numpy as np
import torch

from .anm6 import ANM6
from .anm6_easy import _get_gen_time_series, _get_load_time_series


class ANM6Easy(ANM6):
    """The ``ANM6Easy-v0`` task (anm6_easy.py:8-74) computing on ``device``
    (the card unless the caller passes ``"cpu"``) in ``dtype``."""

    def __init__(self, device="cuda", dtype=torch.float64):
        observation = "state"  # fully observable
        K = 1
        delta_t = 0.25  # 15 minutes between timesteps
        gamma = 0.995
        lamb = 100
        aux_bounds = np.array([[0, 24 / delta_t - 1]])
        costs_clipping = (1, 100)
        super().__init__(observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping, device=device,
                         dtype=dtype)

        self.P_loads = _get_load_time_series()
        self.P_maxs = _get_gen_time_series()

    def init_state(self):
        """Sample s0 at a random time of day (anm6_easy.py:25-52).

        Reference quirks kept: the generator Q entries and storage SoC entry
        are sampled from the *p.u.* device bounds even though the state
        vector is in MVAr/MWh (anm6_easy.py:42-50).
        """
        n_dev, n_gen, n_des = 7, 2, 1
        state = np.zeros(2 * n_dev + n_des + n_gen + self.K)

        t_0 = self.np_random.integers(0, int(24 / self.delta_t))
        state[-1] = t_0

        for dev_id, p_load in zip([1, 3, 5], self.P_loads):
            state[dev_id] = p_load[t_0]
            state[n_dev + dev_id] = p_load[t_0] * self.simulator.devices[dev_id].qp_ratio

        for idx, (dev_id, p_max) in enumerate(zip([2, 4], self.P_maxs)):
            state[2 * n_dev + n_des + idx] = p_max[t_0]
            state[dev_id] = p_max[t_0]
            state[n_dev + dev_id] = self.np_random.uniform(
                self.simulator.devices[dev_id].q_min, self.simulator.devices[dev_id].q_max
            )

        for idx, dev_id in enumerate([6]):
            state[2 * n_dev + idx] = self.np_random.uniform(
                self.simulator.devices[dev_id].soc_min, self.simulator.devices[dev_id].soc_max
            )

        return state

    def next_vars(self, s_t):
        """Deterministic table lookup by time-of-day (anm6_easy.py:54-65)."""
        aux = int((s_t[-1] + 1) % (24 / self.delta_t))
        vars = [p_load[aux] for p_load in self.P_loads]
        vars += [p_max[aux] for p_max in self.P_maxs]
        vars.append(aux)
        return np.array(vars)

    def reset(self, **kwargs):
        obs, info = super().reset(**kwargs)

        # Advance the rendering clock to the sampled time of day
        # (anm6_easy.py:67-74).
        new_date = self.date + self.state[-1] * self.timestep_length
        super().reset_date(new_date)

        return obs, info
