from .ppo import PPOPolicy, PPOTrainer, RolloutBatch
from .rl_config import RLConfig

__all__ = ["RLConfig", "PPOPolicy", "PPOTrainer", "RolloutBatch"]
