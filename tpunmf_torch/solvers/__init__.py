from .admm import admm
from .anls import anls
from .ao_admm import ao_admm
from .beta import mur_beta
from .hals import hals
from .masked import mur_masked
from .mur import mur
from .transform import inverse_transform, transform

__all__ = ["admm", "anls", "ao_admm", "hals", "inverse_transform", "mur", "mur_beta",
           "mur_masked", "transform"]
