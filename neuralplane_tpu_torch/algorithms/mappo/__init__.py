from .policy import MAPPOPolicy
from .trainer import MAPPOTrainer, SharedRolloutBatch

__all__ = ["MAPPOPolicy", "MAPPOTrainer", "SharedRolloutBatch"]
