from .checkpoint import (checkpoint_exists, checkpoint_exists_dcp, load_state,
                         load_state_dcp, save_state, save_state_dcp)
from .npz import load_ntf_results, load_results, save_ntf_results, save_results

__all__ = ["save_results", "load_results", "save_ntf_results", "load_ntf_results",
           "save_state", "load_state", "checkpoint_exists", "save_state_dcp",
           "load_state_dcp", "checkpoint_exists_dcp"]
