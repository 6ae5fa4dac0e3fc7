"""scikit-learn-compatible estimator facade, as ``tpunmf.sklearn_api``.

``tpunmf_torch.sklearn_api.NMF`` mirrors ``sklearn.decomposition.NMF``'s
constructor and attributes (n_components, fit / fit_transform / transform
/ inverse_transform, components_, reconstruction_err_, n_iter_) over the
port's solvers.

sklearn convention: X is (n_samples, n_features) and ``X ~ W @ H`` with
``W = fit_transform(X)`` (n_samples, k) and ``components_ = H`` (k,
n_features), this package's (m, n) orientation.  X that is a tensor stays
on its device (a CPU tensor runs on the CPU); other X goes to the CUDA
device.  The returned arrays are numpy, as in ``tpunmf``.
"""
from __future__ import annotations

import numpy as np

from .core.device import as_input
from .solvers.common import host_array

_SOLVERS = ("mur", "hals", "anls", "admm", "ao_admm")


class NMF:
    """sklearn-style NMF estimator over the tpunmf_torch solvers.

    Args:
      n_components: rank k.
      solver: one of mur | hals | anls | admm | ao_admm ('cd'/'mu' are
        accepted as sklearn aliases for hals/mur).
      beta_loss: 'frobenius' (default), 'kullback-leibler', or
        'itakura-saito' (routes to the beta-divergence solver for IS).
      init: None/'random' or 'nndsvd'/'nndsvda'/'nndsvdar' (sklearn
        names; mapped to this package's zero/mean/random variants).
      tol, max_iter: convergence controls (tol feeds tol1=tol2).
      random_state: int seed of the random init (the solvers' ``key``).
      solver_params: extra kwargs forwarded to the underlying solver.
    """

    def __init__(self, n_components: int, *, solver: str = "mur",
                 beta_loss: str = "frobenius", init=None, tol: float = 1e-4,
                 max_iter: int = 200, random_state: int = 0,
                 **solver_params):
        alias = {"mu": "mur", "cd": "hals"}
        solver = alias.get(solver, solver)
        if solver not in _SOLVERS:
            raise ValueError(f"solver must be one of {_SOLVERS} (or the "
                             "sklearn aliases 'mu'/'cd')")
        self.n_components = int(n_components)
        self.solver = solver
        self.beta_loss = beta_loss
        self.init = init
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.random_state = int(random_state)
        self.solver_params = solver_params
        self.components_ = None
        self.reconstruction_err_ = None
        self.n_iter_ = None
        self._results = None

    # ------------------------------------------------------------ internals

    def _common_kwargs(self):
        kw = dict(max_iter=self.max_iter, tol1=self.tol, tol2=self.tol,
                  key=self.random_state)
        if self.init in ("nndsvd", "nndsvda", "nndsvdar"):
            variant = {"nndsvd": "zero", "nndsvda": "mean",
                       "nndsvdar": "random"}[self.init]
            kw["nndsvd_init"] = (True, variant)
        elif self.init in (None, "random"):
            kw["nndsvd_init"] = (False, "zero")
        else:
            raise ValueError(f"unsupported init {self.init!r}")
        kw.update(self.solver_params)
        return kw

    def _fit(self, x):
        from . import solvers

        kw = self._common_kwargs()
        if self.beta_loss in ("frobenius", 2, 2.0):
            if self.solver in ("mur", "anls", "admm", "ao_admm"):
                kw.setdefault("distance_type", "eu")
            fn = getattr(solvers, self.solver)
            res = fn(x, self.n_components, **kw)
        elif self.beta_loss in ("kullback-leibler", 1, 1.0):
            if self.solver not in ("mur", "admm", "ao_admm"):
                raise ValueError(
                    f"beta_loss=KL needs solver mur/admm/ao_admm, "
                    f"not {self.solver}")
            kw.setdefault("distance_type", "kl")
            fn = getattr(solvers, self.solver)
            res = fn(x, self.n_components, **kw)
        elif self.beta_loss in ("itakura-saito", 0, 0.0):
            if self.solver != "mur":
                raise ValueError("beta_loss=IS needs solver='mur'")
            kw.pop("distance_type", None)
            res = solvers.mur_beta(x, self.n_components, beta=0.0, **kw)
        else:
            raise ValueError(f"unsupported beta_loss {self.beta_loss!r}")
        self._results = res
        self.components_ = np.asarray(res.h)
        self.reconstruction_err_ = float(res.obj_history[-1])
        self.n_iter_ = int(res.i)
        return res

    # ------------------------------------------------------------ sklearn API

    def fit(self, x, y=None):
        self._fit(x)
        return self

    def fit_transform(self, x, y=None):
        res = self._fit(x)
        return np.asarray(res.w)

    def transform(self, x):
        """Encode new SAMPLES (rows) against the learned components, on
        X's device.

        Solves ``min_{W >= 0} ||X - W @ components_||`` row-wise: the
        transposed frame of the port's column encoder."""
        if self.components_ is None:
            raise RuntimeError("call fit first")
        from .solvers import transform as _transform

        x = as_input(x)
        wt = _transform(np.ascontiguousarray(self.components_.T), x.T,
                        distance_type="eu")
        return host_array(wt).T

    def inverse_transform(self, w):
        if self.components_ is None:
            raise RuntimeError("call fit first")
        return host_array(w) @ self.components_
