"""The port's gymnasium.vector.VectorEnv training-loop interface.

The PyTorch counterpart of examples/vector_env.py: all ``num_envs``
environments step in lockstep on the card (``--device cpu`` for the CPU),
with Gymnasium >= 1.0 next-step autoreset; observations, rewards and flags
come back as NumPy arrays, in one device-to-host copy a step.

    python examples/torch_vector_env.py [--device cpu] [--num-envs 256] [--steps 200]
"""
import argparse

import torch

from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.vector import ANMVectorEnv


def run(device="cuda", num_envs=256, steps=200):
    venv = ANMVectorEnv(make_core(torch.float32, device=device), num_envs=num_envs, seed=0)
    obs, _ = venv.reset()
    total, episodes = 0.0, 0
    for t in range(steps):
        actions = venv.action_space.sample()
        obs, rewards, terminated, truncated, _ = venv.step(actions)
        total += rewards.sum()
        episodes += int(terminated.sum())
    print(
        f"{num_envs} envs x {steps} steps on {device}: mean reward {total / (num_envs * steps):.3f}, "
        f"{episodes} episode terminations (autoreset)"
    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--steps", type=int, default=200)
    args = parser.parse_args()
    run(args.device, args.num_envs, args.steps)
