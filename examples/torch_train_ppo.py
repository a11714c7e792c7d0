"""Train a PPO agent on batched ANM6Easy environments, on the port.

The PyTorch counterpart of examples/train_ppo.py: rollouts, GAE and the
clipped-PPO updates all run on the card (``--device cpu`` for the CPU).

    python examples/torch_train_ppo.py [--device cpu] [--iterations 20] [--batch 256]
"""
import argparse

import torch

from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.rl import PPOConfig, PPOTrainer


def run(iterations=20, batch=256, device="cuda"):
    trainer = PPOTrainer(make_core(torch.float32, device), batch, PPOConfig(rollout_steps=64), seed=0)
    history = trainer.train(iterations)
    for i, m in enumerate(history):
        print(f"iter {i}: loss={m['loss']:.3f} mean_reward={m['mean_reward']:.3f}")
    return history


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=20)
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args()
    run(args.iterations, args.batch, args.device)
