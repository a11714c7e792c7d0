"""MPC policy with constant forecasts (reference mpc_constant.py:21-35).

The counterpart of ``gym_anm_tpu.agents.mpc_constant``."""

from __future__ import annotations

import numpy as np
import torch

from .mpc import MPCAgent


class MPCAgentConstant(MPCAgent):
    """The pi_MPC-N^constant policy: future demand and generation are assumed
    constant (at their current values) over the optimization horizon."""

    def forecast(self, env):
        full_state = env.simulator.state

        P_load_forecast = [full_state["dev_p"]["pu"][i] for i in self.load_ids]
        P_gen_forecast = [full_state["gen_p_max"]["pu"][i] for i in self.non_slack_gen_ids]

        P_load_forecast = np.array([P_load_forecast for _ in range(self.planning_steps)]).T
        P_gen_forecast = np.array([P_gen_forecast for _ in range(self.planning_steps)]).T
        return P_load_forecast, P_gen_forecast

    def act_batch(self, state_vecs, warm_start=False, warm_shift=False, polish=False, sharding=None):
        """Batched policy over B environment lanes.

        ``state_vecs [B, state_n]`` (a tensor or a host array) are canonical
        state vectors (as returned by the batched env: [dev_p (MW), dev_q
        (MVAr), des_soc (MWh), gen_p_max (MW), aux]); returns actions
        ``[B, action_n]``, a float64 tensor on the agent's device.

        ``warm_start=True`` reuses the previous call's ADMM iterate
        (receding-horizon warm start, see ``MPCAgent.solve_batch``);
        ``warm_shift=True`` additionally realigns it by one stage (a
        near-no-op for this constant-forecast policy, where the optimal
        plan is stage-stationary).  ``sharding`` splits the lanes over the
        ranks of a mesh (``MPCAgent.solve_batch``).
        """
        sv = self._state_vecs(state_vecs)
        spec = self.spec
        d = spec.n_dev
        base = self.baseMVA
        load_pos = torch.as_tensor(np.asarray(spec.load_pos, dtype=np.int64), device=self.device)
        loads = sv[:, load_pos] / base  # [B, n_load] p.u.
        p_pot = sv[:, 2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / base
        socs = sv[:, 2 * d : 2 * d + spec.n_des] / base
        N = self.planning_steps
        load_f = loads[:, :, None].expand(-1, -1, N)
        gen_f = p_pot[:, :, None].expand(-1, -1, N)
        return self.solve_batch(
            load_f, gen_f, socs, warm_start=warm_start, warm_shift=warm_shift, polish=polish, sharding=sharding
        )
