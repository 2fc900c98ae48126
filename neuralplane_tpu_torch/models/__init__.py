from .c172p import C172PModel
from .f16 import F16Model, F16State, F16StateFM, from_fm, to_fm
from .uav import UAVModel

__all__ = ["C172PModel", "F16Model", "F16State", "F16StateFM", "UAVModel", "from_fm",
           "to_fm"]
