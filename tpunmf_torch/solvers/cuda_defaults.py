"""The port's route switches: ``tpunmf``'s defaults for the two single-pass
variants that it leaves off (tpunmf/solvers/tpu_defaults.py:40-67), and
for ANLS's masked NNLS solves (:70-91).

The solvers read them at run time through this module
(``cuda_defaults.hals_single_pass(x.device)``), so that a test or
``chip_smoke.py`` can flip one.  The single-pass values are ``tpunmf``'s,
chosen by its measurements on a TPU v5e, and the ANLS values its CPU
values; none was measured on this card.  The rest of ``tpu_defaults.py``
(``anls_device_loop`` and ``anls_use_pallas`` among it) works around TPU
compiler faults and has no counterpart here.
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


def anls_masked_solver(device) -> str:
    """'chol' (batched Cholesky, exact) or 'cg' (masked CG) for ANLS's
    masked NNLS solves.  'chol', ``tpunmf``'s value off the TPU
    (tpu_defaults.py:70-75); not measured on this card."""
    return "chol"


def anls_cg_iters(device) -> int:
    """CG steps per masked solve on the 'cg' path (0 = the exact bound
    l + 8).  0, ``tpunmf``'s value off the TPU (tpu_defaults.py:78-90); not
    measured on this card."""
    return 0
