from .f16 import F16Model, F16State, F16StateFM, from_fm, to_fm

__all__ = ["F16Model", "F16State", "F16StateFM", "from_fm", "to_fm"]
