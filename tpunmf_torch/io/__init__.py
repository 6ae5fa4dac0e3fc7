from .checkpoint import checkpoint_exists, load_state, save_state
from .npz import load_ntf_results, load_results, save_ntf_results, save_results

__all__ = ["save_results", "load_results", "save_ntf_results", "load_ntf_results",
           "save_state", "load_state", "checkpoint_exists"]
