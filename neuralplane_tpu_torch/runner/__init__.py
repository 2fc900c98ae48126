from .base import Runner
from .f16sim import F16SimRunner, RolloutCarry
from .gym_adapter import GymEnvAdapter, GymRunner

__all__ = ["Runner", "F16SimRunner", "RolloutCarry", "GymEnvAdapter", "GymRunner"]
