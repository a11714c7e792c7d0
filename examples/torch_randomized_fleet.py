"""Step a domain-randomized fleet of G grid variants x L lanes, on the port.

The PyTorch counterpart of examples/randomized_fleet.py: each variant is
the 6-bus ANM6Easy grid with lognormal jitter on its branch impedances; one
policy (here: uniform random) drives the whole heterogeneous fleet, and
``train_robust`` trains one PPO policy against every variant at once
(``--device cpu`` for the CPU).

    python examples/torch_randomized_fleet.py [--device cpu]
"""
import argparse

import torch

from gym_anm_tpu_torch.envs.randomized import MultiBatchedEnv, randomized_anm6easy_cores


def run(n_variants=4, lanes=256, steps=32, device="cuda"):
    cores = randomized_anm6easy_cores(n_variants, seed=0, r_sigma=0.2, x_sigma=0.2, device=device)
    fleet = MultiBatchedEnv(cores, lanes, generator=torch.Generator(device=device).manual_seed(0))
    states, _ = fleet.reset()
    states, (rew, term) = fleet.rollout(states, steps)  # rew [T, G, L]
    means = rew.mean(dim=(0, 2)).tolist()
    for g, m in enumerate(means):
        tag = "nominal " if g == 0 else f"variant {g}"
        print(f"{tag}: mean reward {m:+.3f}")
    return means


def train_robust(n_variants=4, lanes=64, iterations=10, device="cuda"):
    """Train one PPO policy against the whole fleet (robust to grid
    parameters)."""
    from gym_anm_tpu_torch.envs.randomized import ppo_trainer_for_fleet
    from gym_anm_tpu_torch.rl import PPOConfig

    cores = randomized_anm6easy_cores(n_variants, seed=0, r_sigma=0.2, x_sigma=0.2, device=device)
    trainer = ppo_trainer_for_fleet(cores, lanes, config=PPOConfig(rollout_steps=32))
    history = trainer.train(iterations)
    for i, m in enumerate(history):
        print(f"iter {i}: loss={m['loss']:.3f} mean_reward={m['mean_reward']:.3f}")
    return history


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(device=args.device)
    train_robust(device=args.device)
