from .activeset import masked_solve, masked_solve_cg, nnls, nnls_activeset, trips
from .bpp import nnls_bpp

__all__ = [
    "nnls",
    "nnls_activeset",
    "nnls_bpp",
    "masked_solve",
    "masked_solve_cg",
    "trips",
]
