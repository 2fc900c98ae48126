from .base import MODELS, ControlEnv, Env
from .planning import PlanningEnv, PlanningState
from .types import EnvState, StepOutput
from .wrappers import GymVecEnv, make_control_vec_env

__all__ = ["MODELS", "ControlEnv", "Env", "EnvState", "GymVecEnv", "PlanningEnv",
           "PlanningState", "StepOutput", "make_control_vec_env"]
