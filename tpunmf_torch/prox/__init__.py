from .operators import (prox, prox_l1inf, prox_l1inf_ball, prox_l1inf_transpose,
                        prox_l1n, prox_l2n, prox_nn)

__all__ = ["prox", "prox_nn", "prox_l1n", "prox_l2n", "prox_l1inf",
           "prox_l1inf_transpose", "prox_l1inf_ball"]
