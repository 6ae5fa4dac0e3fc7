from .admm import admm
from .anls import anls
from .ao_admm import ao_admm
from .beta import beta_divergence, mur_beta
from .hals import hals
from .masked import mur_masked
from .multilevel import multilevel, mur_multilevel
from .mur import mur
from .onmf import onmf, orthogonality_residual
from .robust import robust_nmf
from .semi import semi_nmf
from .transform import inverse_transform, transform

__all__ = ["admm", "anls", "ao_admm", "beta_divergence", "hals", "inverse_transform",
           "multilevel", "mur", "mur_beta", "mur_masked", "mur_multilevel", "onmf",
           "orthogonality_residual", "robust_nmf", "semi_nmf", "transform"]
