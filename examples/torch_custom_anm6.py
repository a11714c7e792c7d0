"""A custom rendering-capable task on the ANM6 grid, on the port.

The PyTorch counterpart of examples/custom_anm6.py: random demands and
generation potentials each step, with the time-of-day index as the
auxiliary variable; the environment computes on the card (``--device cpu``
for the CPU).

    python examples/torch_custom_anm6.py [--device cpu]
"""
import argparse

import numpy as np

from gym_anm_tpu_torch.envs.anm6.anm6 import ANM6


class CustomANM6Environment(ANM6):
    """A gym-anm task built on top of the ANM6 grid."""

    def __init__(self, device="cuda"):
        observation = "state"
        K = 1
        delta_t = 0.25
        gamma = 0.9
        lamb = 100
        aux_bounds = np.array([[0, 10]])
        costs_clipping = (1, 100)
        seed = 1

        super().__init__(observation, K, delta_t, gamma, lamb, aux_bounds, costs_clipping, seed, device=device)

    def init_state(self):
        n_dev = self.simulator.N_device
        n_des = self.simulator.N_des
        n_gen = self.simulator.N_non_slack_gen
        s = self.np_random.random(2 * n_dev + n_des + n_gen)
        aux = 0  # initial time: 00:00
        return np.hstack((s, aux))

    def next_vars(self, s_t):
        next_var = [
            -10 * self.np_random.random(),  # residential load [-10, 0] MW
            30 * self.np_random.random(),  # PV max generation [0, 30] MW
            -30 * self.np_random.random(),  # industrial load [-30, 0] MW
            50 * self.np_random.random(),  # wind max generation [0, 50] MW
            -30 * self.np_random.random(),  # EV-charging load [-30, 0] MW
        ]
        aux = int((s_t[-1] + 1) % (24 / self.delta_t))
        next_var.append(aux)
        return np.array(next_var)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    env = CustomANM6Environment(device=args.device)
    env.reset()

    for t in range(10):
        a = env.action_space.sample()
        o, r, terminated, _, _ = env.step(a)
        print(f"t={t}, r_t={r:.3}")
