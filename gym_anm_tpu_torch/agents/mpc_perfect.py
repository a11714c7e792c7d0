"""MPC policy with perfect forecasts (reference mpc_perfect.py:21-40).

The counterpart of ``gym_anm_tpu.agents.mpc_perfect``.  Only works on
environments exposing the fixed daily time series as ``env.P_loads`` /
``env.P_maxs`` with the time-of-day index as the last state variable (e.g.
ANM6Easy)."""

from __future__ import annotations

import numpy as np
import torch

from .mpc import MPCAgent


class MPCAgentPerfect(MPCAgent):
    """The pi_MPC-N^perfect policy: future demand and generation are read
    from the environment's true time series.

    ``P_loads``/``P_maxs`` (each ``[n, T_day]``, MW) may be passed at
    construction to enable the batched fleet path :meth:`act_batch` --
    they are the same fixed daily tables the host path reads off the env
    (for ANM6Easy, those of ``envs/anm6/anm6_easy.py``).  Keyword arguments
    after them (``solver_x64``, ``warm_start``, ``warm_shift``, ``device``)
    go to :class:`MPCAgent`."""

    def __init__(
        self,
        simulator,
        action_space,
        gamma,
        safety_margin=0.9,
        planning_steps=1,
        P_loads=None,
        P_maxs=None,
        **kwargs,
    ):
        super().__init__(simulator, action_space, gamma, safety_margin, planning_steps, **kwargs)
        self.P_loads = None if P_loads is None else np.asarray(P_loads, dtype=float)
        self.P_maxs = None if P_maxs is None else np.asarray(P_maxs, dtype=float)
        self._tables = None if P_loads is None or P_maxs is None else (
            self._tensor(self.P_loads, torch.float64), self._tensor(self.P_maxs, torch.float64)
        )

    def forecast(self, env):
        t_start = int(env.state[-1]) + 1
        t_end = t_start + self.planning_steps
        P_loads = env.P_loads
        P_gen_pot = env.P_maxs

        while t_end > P_loads.shape[1]:
            P_loads = np.concatenate((P_loads, env.P_loads), axis=-1)
            P_gen_pot = np.concatenate((P_gen_pot, env.P_maxs), axis=-1)

        P_load_forecast = P_loads[:, t_start:t_end] / self.baseMVA
        P_gen_forecast = P_gen_pot[:, t_start:t_end] / self.baseMVA
        return P_load_forecast, P_gen_forecast

    def act_batch(self, state_vecs, warm_start=False, warm_shift=True, polish=False):
        """Batched perfect-forecast policy over B environment lanes.

        ``state_vecs [B, state_n]`` are canonical state vectors whose last
        entry is the time-of-day index (the ANM6Easy/feeder convention);
        the true future is read from the daily tables handed to the
        constructor, wrapping across days (mpc_perfect.py:24-27).
        Returns actions ``[B, action_n]`` in MW/MVAr, a float64 tensor on
        the agent's device.
        """
        if self._tables is None:
            raise ValueError(
                "act_batch needs the task's daily tables: construct with "
                "MPCAgentPerfect(..., P_loads=env.P_loads, P_maxs=env.P_maxs)"
            )
        P_loads, P_maxs = self._tables
        sv = self._state_vecs(state_vecs)
        spec = self.spec
        d = spec.n_dev
        base = self.baseMVA
        N = self.planning_steps
        T_day = P_loads.shape[1]

        t0 = sv[:, -1].to(torch.int64)  # [B] time-of-day indices
        idx = (t0[:, None] + 1 + torch.arange(N, device=self.device)[None, :]) % T_day  # [B, N]
        load_f = P_loads[:, idx].permute(1, 0, 2) / base  # [B, n_load, N]
        gen_f = P_maxs[:, idx].permute(1, 0, 2) / base  # [B, n_gen-1, N]
        socs = sv[:, 2 * d : 2 * d + spec.n_des] / base
        # Perfect forecasts are time-varying, so the receding-horizon
        # stage shift genuinely realigns the carry (default on).
        return self.solve_batch(load_f, gen_f, socs, warm_start=warm_start, warm_shift=warm_shift, polish=polish)
