"""Run the perfect-forecast MPC DC-OPF policy on the port's ANM6Easy-v0.

The PyTorch counterpart of examples/mpc_perfect.py: the environment comes
from ``gymnasium.make`` through the port's namespaced id and computes on
the card (``--device cpu`` for the CPU), as does the agent's ADMM.

    python examples/torch_mpc_perfect.py [--device cpu] [--steps 100]
"""
import argparse

import gymnasium as gym

from gym_anm_tpu_torch.agents import MPCAgentPerfect

ENV_ID = "gym_anm_tpu_torch.envs.registration:gym_anm_tpu_torch/ANM6Easy-v0"


def run(steps=100, device="cuda"):
    env = gym.make(ENV_ID, device=device)
    o, _ = env.reset()

    raw_env = env.unwrapped
    agent = MPCAgentPerfect(
        raw_env.simulator, env.action_space, raw_env.gamma, safety_margin=0.96, planning_steps=10, device=device
    )

    rewards = []
    for t in range(steps):
        a = agent.act(env.unwrapped)
        obs, r, terminated, _, _ = env.step(a)
        print(f"t={t}, r_t={r:.3}")
        rewards.append(r)
    return rewards


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=100)
    args = parser.parse_args()
    run(args.steps, args.device)
