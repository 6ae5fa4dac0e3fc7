"""The port's route switches: ``tpunmf``'s defaults for the two single-pass
variants that it leaves off (tpunmf/solvers/tpu_defaults.py:40-67).

The solvers read them at run time through this module
(``cuda_defaults.hals_single_pass(x.device)``), so that a test or
``chip_smoke.py`` can flip one.  The values are ``tpunmf``'s, chosen by its
measurements on a TPU v5e; none was measured on this card.  The rest of
``tpu_defaults.py`` works around TPU compiler faults and has no
counterpart here.
"""
from __future__ import annotations


def mur_single_pass_variant(device) -> str:
    """'auto' (``mur_iteration_eu``) or 'dma' (``mur_iteration_eu_dma``,
    the copies overlapped with the products by hand) for MUR's single-pass
    EU route.  'auto', as ``tpunmf`` (tpu_defaults.py:40-48)."""
    return "auto"


def hals_single_pass(device) -> bool:
    """Whether HALS takes its whole W half in one pass over X
    (``hals_iteration_eu``) where ``hals_iter_tileable`` gives a strip
    height.  False, as ``tpunmf`` (tpu_defaults.py:58-67)."""
    return False
