from .base import ControlEnv, Env
from .types import EnvState, StepOutput

__all__ = ["ControlEnv", "Env", "EnvState", "StepOutput"]
