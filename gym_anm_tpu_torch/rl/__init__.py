"""Trainers over batched ANM environments: PPO and SAC."""

from .ppo import ActorCritic, PPOConfig, PPOTrainer
from .sac import SACConfig, SACTrainer

__all__ = ["PPOConfig", "PPOTrainer", "ActorCritic", "SACConfig", "SACTrainer"]
