"""The tasks, batched lockstep environments and domain-randomized fleets
(no Gymnasium adapter: the package imports neither JAX nor Gymnasium)."""

from .batched import BatchedEnv
from .randomized import (
    MultiBatchedEnv,
    perturb_branches,
    ppo_trainer_for_fleet,
    sac_trainer_for_fleet,
    randomized_anm6easy_cores,
    randomized_feeder33_cores,
)

__all__ = [
    "BatchedEnv",
    "MultiBatchedEnv",
    "perturb_branches",
    "ppo_trainer_for_fleet",
    "sac_trainer_for_fleet",
    "randomized_anm6easy_cores",
    "randomized_feeder33_cores",
]
