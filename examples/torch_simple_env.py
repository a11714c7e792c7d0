"""A minimal custom 2-bus environment on the port (mirrors the reference example):

* Slack generator (bus 0) --- Load (bus 1),
* random initial state,
* load demands sampled in [-10, 0] each step,
* one (unused) auxiliary variable.

The PyTorch counterpart of examples/simple_env.py; the environment computes
on the card (``--device cpu`` for the CPU).

    python examples/torch_simple_env.py [--device cpu] [--steps 10]
"""
import argparse

import numpy as np

from gym_anm_tpu_torch.envs.anm_env import ANMEnv

network = {
    "baseMVA": 100,
    "bus": np.array([[0, 0, 132, 1.0, 1.0], [1, 1, 33, 1.1, 0.9]]),
    "device": np.array(
        [
            [0, 0, 0, None, 200, -200, 200, -200, None, None, None, None, None, None, None],
            [1, 1, -1, 0.2, 0, -10, None, None, None, None, None, None, None, None, None],
        ],
        dtype=object,
    ),
    "branch": np.array([[0, 1, 0.01, 0.1, 0.0, 3, 1, 0]]),
}


class SimpleEnvironment(ANMEnv):
    """An example of a simple 2-bus custom environment."""

    def __init__(self, device="cuda"):
        observation = "state"  # fully observable environment
        K = 1  # 1 auxiliary variable
        delta_t = 0.25  # 15min intervals
        gamma = 0.9  # discount factor
        lamb = 100  # penalty weighting hyperparameter
        aux_bounds = np.array([[0, 10]])  # bounds on auxiliary variable
        costs_clipping = (1, 100)  # reward clipping parameters
        seed = 1  # random seed

        super().__init__(network, observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping, seed,
                         device=device)

    def init_state(self):
        """Return a state vector with random values in [0, 1]."""
        n_dev = self.simulator.N_device
        n_des = self.simulator.N_des
        n_gen = self.simulator.N_non_slack_gen
        return self.np_random.random(2 * n_dev + n_des + n_gen + self.K)

    def next_vars(self, s_t):
        """A random load injection in [-10, 0] and a random aux var in [0, 10]."""
        P_load = -10 * self.np_random.random()
        aux = self.np_random.integers(0, 10)
        return np.array([P_load, aux])


def run(steps=10, device="cuda"):
    env = SimpleEnvironment(device=device)
    env.reset()

    rewards = []
    for t in range(steps):
        a = env.action_space.sample()
        o, r, terminated, _, _ = env.step(a)
        print(f"t={t}, r_t={r:.3}")
        rewards.append(r)
    return rewards


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    run(args.steps, args.device)
