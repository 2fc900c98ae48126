from .buffer import RolloutBatch, compute_advantages, compute_returns, make_chunks
from .policy import PPOPolicy
from .trainer import PPOTrainer, train_state_from_jax

__all__ = ["RolloutBatch", "compute_returns", "compute_advantages",
           "make_chunks", "PPOPolicy", "PPOTrainer", "train_state_from_jax"]
