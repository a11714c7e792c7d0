"""Train a SAC agent on batched ANM6Easy environments, on the port.

The PyTorch counterpart of examples/train_sac.py, the off-policy
counterpart of ``torch_train_ppo.py``: the replay buffer lives on the card,
and each iteration collects environment steps, then takes gradient steps
(``--device cpu`` for the CPU).

    python examples/torch_train_sac.py [--device cpu] [--iterations 20] [--batch 256]
"""
import argparse

import torch

from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.rl import SACConfig, SACTrainer


def run(iterations=20, batch=256, device="cuda"):
    cfg = SACConfig(collect_steps=32, grad_steps=64, train_batch=512)
    trainer = SACTrainer(make_core(torch.float32, device), batch, cfg, seed=0)
    history = trainer.train(iterations)
    for i, m in enumerate(history):
        print(
            f"iter {i}: critic={m['critic_loss']:.3f} actor={m['actor_loss']:.3f} "
            f"alpha={m['alpha']:.3f} mean_reward={m['mean_reward']:.3f}"
        )
    return history


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=20)
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args()
    run(args.iterations, args.batch, args.device)
