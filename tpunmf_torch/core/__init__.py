from .convergence import converged, convergence_check
from .losses import distance, eu_elementwise_sum, eu_objective_gram, kl_elementwise_sum
from .types import AdmmExperiment, AnlsExperiment, AoAdmmExperiment, MurExperiment, Results

__all__ = [
    "converged",
    "convergence_check",
    "distance",
    "eu_objective_gram",
    "kl_elementwise_sum",
    "eu_elementwise_sum",
    "MurExperiment",
    "AnlsExperiment",
    "AdmmExperiment",
    "AoAdmmExperiment",
    "Results",
]
