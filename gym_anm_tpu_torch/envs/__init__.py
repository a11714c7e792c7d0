"""The tasks, batched lockstep environments, domain-randomized fleets and
the Gymnasium adapters.

Importing this package imports no Gymnasium: the Gymnasium classes
(``ANMEnv``, ``ANM6``, ``ANM6Easy``, ``ANMVectorEnv``) are imported on first
access, from :mod:`.anm_env`, :mod:`.anm6.anm6`, :mod:`.anm6.anm6_easy_gym`
and :mod:`.vector`."""

from .batched import BatchedEnv
from .randomized import (
    MultiBatchedEnv,
    perturb_branches,
    ppo_trainer_for_fleet,
    sac_trainer_for_fleet,
    randomized_anm6easy_cores,
    randomized_feeder33_cores,
)

_GYMNASIUM_CLASSES = {
    "ANMEnv": ".anm_env",
    "ANM6": ".anm6.anm6",
    "ANM6Easy": ".anm6.anm6_easy_gym",
    "ANMVectorEnv": ".vector",
}


def __getattr__(name):
    if name in _GYMNASIUM_CLASSES:
        import importlib

        return getattr(importlib.import_module(_GYMNASIUM_CLASSES[name], __name__), name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


__all__ = [
    "ANMEnv",
    "ANM6",
    "ANM6Easy",
    "BatchedEnv",
    "ANMVectorEnv",
    "MultiBatchedEnv",
    "perturb_branches",
    "ppo_trainer_for_fleet",
    "sac_trainer_for_fleet",
    "randomized_anm6easy_cores",
    "randomized_feeder33_cores",
]
