from .base import MODELS, ControlEnv, Env
from .combat import CombatState, MultipleCombatEnv, SingleCombatEnv
from .planning import PlanningEnv, PlanningState
from .types import EnvState, StepOutput
from .wrappers import GymVecEnv, make_control_vec_env

__all__ = ["MODELS", "CombatState", "ControlEnv", "Env", "EnvState", "GymVecEnv",
           "MultipleCombatEnv", "PlanningEnv", "PlanningState", "SingleCombatEnv",
           "StepOutput", "make_control_vec_env"]
