from .base import Runner
from .f16sim import F16SimRunner, RolloutCarry

__all__ = ["Runner", "F16SimRunner", "RolloutCarry"]
