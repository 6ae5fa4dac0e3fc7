from .admm import admm
from .anls import anls
from .ao_admm import ao_admm
from .beta import beta_divergence, mur_beta
from .convex import convex_nmf
from .gnmf import gnmf, knn_graph
from .hals import hals
from .masked import mur_masked
from .multilevel import multilevel, mur_multilevel
from .mur import mur
from .nmtf import nmtf
from .ntf import NtfResults, cp_reconstruct, mttkrp, ntf
from .online import OnlineNMF, online_nmf
from .onmf import onmf, orthogonality_residual
from .robust import robust_nmf
from .semi import semi_nmf
from .streaming import mur_streaming
from .streaming_sharded import mur_streaming_sharded
from .symnmf import symnmf
from .transform import inverse_transform, transform

__all__ = ["admm", "anls", "ao_admm", "beta_divergence", "convex_nmf", "cp_reconstruct",
           "gnmf", "hals", "inverse_transform", "knn_graph", "multilevel", "mttkrp", "mur",
           "mur_beta", "mur_masked", "mur_multilevel", "mur_streaming", "mur_streaming_sharded", "nmtf", "ntf",
           "NtfResults", "OnlineNMF", "online_nmf", "onmf", "orthogonality_residual",
           "robust_nmf", "semi_nmf", "symnmf", "transform"]
