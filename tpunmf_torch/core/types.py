"""Result / experiment record types (same names and fields as ``tpunmf``).

``MurExperiment``, ``AnlsExperiment``, ``AdmmExperiment`` and
``AoAdmmExperiment`` carry exactly the fields the reference encodes into
its save-file name grammar (reference: nmf/nmf.py:95-126, nmf/mur.py:77,
nmf/anls.py:81, nmf/admm.py:262, nmf/ao_admm.py:230), so persistence stays
drop-in compatible.  ``Results`` matches the reference's
``Results(w, h, i, obj_history, experiment)``.
"""
from __future__ import annotations

from collections import namedtuple

MurExperiment = namedtuple(
    "Experiment",
    "method components distance_type nndsvd_init max_iter tol1 tol2 lambda_w lambda_h",
)

AnlsExperiment = namedtuple(
    "Experiment",
    "method components distance_type nndsvd_init max_iter tol1 tol2 lambda_w lambda_h fcnnls",
)

AdmmExperiment = namedtuple(
    "Experiment",
    "method components rho distance_type nndsvd_init min_iter max_iter tol1 tol2 "
    "lambda_w prox_w lambda_h prox_h",
)

AoAdmmExperiment = namedtuple(
    "Experiment",
    "method components distance_type nndsvd_init min_iter max_iter admm_iter tol1 tol2 "
    "lambda_w prox_w lambda_h prox_h",
)

Results = namedtuple("Results", "w h i obj_history experiment")
