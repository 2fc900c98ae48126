from .base import Runner
from .f16sim import F16SimRunner, RolloutCarry
from .gym_adapter import GymEnvAdapter, GymRunner
from .mappo import MAPPOSelfplayRunner
from .selfplay import SelfplayCarry, SelfplayRunner, pool_slices, team_merge, team_split

__all__ = ["Runner", "F16SimRunner", "RolloutCarry", "GymEnvAdapter", "GymRunner",
           "MAPPOSelfplayRunner", "SelfplayCarry", "SelfplayRunner", "pool_slices",
           "team_merge", "team_split"]
