"""Template for creating new environments on the port.

The PyTorch counterpart of examples/new_env_template.py: fill in the
``...``; the environment computes on ``device`` (the card unless the caller
passes ``"cpu"``).
"""
from gym_anm_tpu_torch.envs.anm_env import ANMEnv


class CustomEnvironment(ANMEnv):
    def __init__(self, device="cuda"):
        network = {"baseMVA": ..., "bus": ..., "device": ..., "branch": ...}  # power grid specs
        observation = ...  # observation space
        K = ...  # number of auxiliary variables
        delta_t = ...  # time interval between timesteps
        gamma = ...  # discount factor
        lamb = ...  # penalty weighting hyperparameter
        aux_bounds = ...  # bounds on auxiliary variables (optional)
        costs_clipping = ...  # reward clipping parameters (optional)
        seed = ...  # random seed (optional)

        super().__init__(network, observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping, seed,
                         device=device)

    def init_state(self):
        ...

    def next_vars(self, s_t):
        ...

    def observation_bounds(self):  # optional
        ...

    def render(self, mode="human"):  # optional
        ...

    def close(self):  # optional
        ...
