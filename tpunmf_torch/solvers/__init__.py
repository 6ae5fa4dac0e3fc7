from .hals import hals
from .masked import mur_masked
from .mur import mur

__all__ = ["hals", "mur", "mur_masked"]
