from .base import MODELS, ControlEnv, Env
from .combat import CombatState, MultipleCombatEnv, SingleCombatEnv
from .combat_shoot import (MultipleCombatShootEnv, ShootCombatState, SingleCombatShootEnv,
                           TeamShootCombatState)
from .planning import PlanningEnv, PlanningState
from .types import EnvState, StepOutput
from .wrappers import GymVecEnv, make_control_vec_env

__all__ = ["MODELS", "CombatState", "ControlEnv", "Env", "EnvState", "GymVecEnv",
           "MultipleCombatEnv", "MultipleCombatShootEnv", "PlanningEnv", "PlanningState",
           "ShootCombatState", "SingleCombatEnv", "SingleCombatShootEnv", "StepOutput",
           "TeamShootCombatState", "make_control_vec_env"]
