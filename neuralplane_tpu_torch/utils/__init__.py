from .config import EnvConfig, InitState, load_config
from .math import wrap_2PI, wrap_PI

__all__ = ["EnvConfig", "InitState", "load_config", "wrap_2PI", "wrap_PI"]
