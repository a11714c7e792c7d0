"""Gymnasium ids of the port's environments.

The counterpart of the registrations of ``gym_anm_tpu/__init__.py:28-41``,
under the port's own namespace so that both packages can register in one
process.  Importing this module registers them; ``gymnasium.make`` imports
it when the id names it before a colon::

    gym.make("gym_anm_tpu_torch.envs.registration:gym_anm_tpu_torch/ANM6Easy-v0", device="cpu")

This module imports Gymnasium.
"""

from gymnasium.envs.registration import register

NAMESPACE = "gym_anm_tpu_torch"
ENTRY_POINTS = {
    "ANM6Easy-v0": "gym_anm_tpu_torch.envs.anm6.anm6_easy_gym:ANM6Easy",
    "ANMFeeder33-v0": "gym_anm_tpu_torch.envs.feeder33_gym:Feeder33Env",
    "ANMFeeder141-v0": "gym_anm_tpu_torch.envs.feeder141_gym:Feeder141Env",
    "ANMBaranWu33-v0": "gym_anm_tpu_torch.envs.baranwu33_gym:Baranwu33Env",
}

for _name, _entry_point in ENTRY_POINTS.items():
    register(id="%s/%s" % (NAMESPACE, _name), entry_point=_entry_point)
