"""MPC DC-OPF baseline agents (the counterpart of ``gym_anm_tpu.agents``).

Built from the :class:`~gym_anm_tpu_torch.simulator.Simulator` facade; the
batched solves (``solve_batch`` / ``act_batch``) run on the agent's
``device``."""

from .mpc import MPCAgent
from .mpc_constant import MPCAgentConstant
from .mpc_perfect import MPCAgentPerfect
from .mpc_banded import MPCAgentBanded, MPCAgentConstantBanded, MPCAgentPerfectBanded

__all__ = [
    "MPCAgent",
    "MPCAgentConstant",
    "MPCAgentPerfect",
    "MPCAgentBanded",
    "MPCAgentConstantBanded",
    "MPCAgentPerfectBanded",
]
