from .mappo import MAPPOPolicy, MAPPOTrainer, SharedRolloutBatch
from .ppo import PPOPolicy, PPOTrainer, RolloutBatch
from .rl_config import RLConfig

__all__ = ["RLConfig", "MAPPOPolicy", "MAPPOTrainer", "PPOPolicy", "PPOTrainer",
           "RolloutBatch", "SharedRolloutBatch"]
