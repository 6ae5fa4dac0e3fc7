from .admm import admm
from .hals import hals
from .masked import mur_masked
from .mur import mur

__all__ = ["admm", "hals", "mur", "mur_masked"]
