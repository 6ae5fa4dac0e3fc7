from .fused import (eu_residual_obj, kl_obj, kl_ratio, kl_ratio_and_obj,
                    kl_ratio_ref)
from .hals_sweep import gs_sweep
from .masked_fused import masked_h_update, masked_w_update
from .mur_fused import mur_h_update, mur_w_update
from .topk_select import blockmax_relayout, score_blockmax_relayout

__all__ = ["eu_residual_obj", "kl_obj", "kl_ratio", "kl_ratio_ref",
           "kl_ratio_and_obj", "gs_sweep", "masked_w_update", "masked_h_update",
           "mur_w_update", "mur_h_update", "blockmax_relayout",
           "score_blockmax_relayout"]
