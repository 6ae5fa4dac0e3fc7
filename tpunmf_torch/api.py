"""Public facade: the ``NMF`` class, as in ``tpunmf.api``.

Same surface as ``tpunmf.NMF``: ``NMF(data, factors, saving=True,
param_file=None)``, ``.w`` / ``.h``, the sklearn-style ``components_``,
``reconstruction_err_``, ``fit``, ``fit_transform``, ``transform`` and
``inverse_transform``, ``factorize``, ``default_save_name`` (the
reference's file-name grammar, nmf/nmf.py:95-126, and ``tpunmf``'s
``ntf_...`` name for an N-way fit), ``save_factorization`` and
``load_factorization`` (either layout, told apart by ``n_modes``).
Every method of ``tpunmf``'s dispatch list is ported: ``"mur"`` (with
``mask=`` for masked/weighted MUR and ``beta=`` for the beta-divergence
MUR), ``"anls"``, ``"hals"``, ``"admm"``, ``"ao_admm"``, ``"semi_nmf"``,
``"onmf"``, ``"robust"``, ``"ntf"`` (N-way CP: ``.w`` / ``.h`` are None,
``fit_transform`` gives the mode-0 factor, ``transform`` and
``inverse_transform`` refuse), and the ``multilevel=`` warm start of mur
and hals.  Every method runs across devices too (``tpunmf_torch.parallel``):
``NMF(data, k, mesh=m)`` keeps the mesh, and ``factorize`` then runs the
method's mesh driver (``tpunmf``'s GSPMD run, its collectives written
out): ``parallel.mur_mesh``, ``mur_masked_mesh`` (with ``mask=``),
``mur_beta_mesh`` (with ``beta=``), ``hals_mesh``, ``anls_mesh``,
``admm_mesh``, ``ao_admm_mesh``, ``semi_nmf_mesh``, ``onmf_mesh``,
``robust_mesh``, ``ntf_mesh``, or ``multilevel_mesh`` (with
``multilevel=``), each with every keyword of the one-device solver,
blocks and checkpoints included (a mesh run's ``.npz`` checkpoint is the
one-device one; ``checkpoint_backend="dcp"`` writes a sharded one);
``factorize("mur", schedule="ulysses" | "rank")`` runs
``parallel.mur_sharded`` and needs a mesh.  Every rank passes the global
data and gets the same results.
"""
from __future__ import annotations

import os
from collections import namedtuple
from importlib import import_module

from .core.types import Results
from .io.npz import (is_ntf_file, load_ntf_results, load_results, save_ntf_results,
                     save_results)

# tpunmf's dispatch list, kept whole so an unknown method fails the same way
_METHODS = ("mur", "anls", "admm", "ao_admm", "hals", "semi_nmf", "onmf",
            "ntf", "robust")
# every method of the list is ported
_PORTED = _METHODS
# every method runs over mesh= (tpunmf_torch.parallel), by driver
_MESH_METHODS = {"mur": "mur_mesh", "hals": "hals_mesh", "anls": "anls_mesh",
                 "admm": "admm_mesh", "ao_admm": "ao_admm_mesh",
                 "semi_nmf": "semi_nmf_mesh", "onmf": "onmf_mesh", "robust": "robust_mesh",
                 "ntf": "ntf_mesh"}


class NMF:
    """Non-negative matrix factorization (MUR, masked and beta-divergence
    MUR, ANLS, HALS, ADMM, AO-ADMM, semi-NMF, ONMF, robust NMF, N-way CP
    and the multilevel warm start).

    Example:
        >>> from tpunmf_torch import NMF
        >>> model = NMF(torch.as_tensor(data, device="cuda"), factors)
        >>> model.factorize(method="mur", **method_params)
        >>> print(model.w, model.h)
    """

    def __init__(self, data=None, factors=None, saving=True, param_file=None,
                 mesh=None):
        # the data stay global: the mesh's drivers keep each rank's block
        self.data = data
        self.factors = factors
        self.saving = saving
        self.results = None
        self.method_params = {}
        self.mesh = mesh

        if param_file is not None:
            try:
                parameters = import_module(param_file)
            except ImportError:
                print("No parameter file found.")
                return
            self.method_params = dict(parameters.method_params)

    # getattr: N-way (ntf) results carry .factors instead of .w/.h
    @property
    def w(self):
        return None if self.results is None else getattr(self.results, "w", None)

    @property
    def h(self):
        return None if self.results is None else getattr(self.results, "h", None)

    # sklearn-style aliases
    @property
    def components_(self):
        """sklearn alias: the (k, n) coefficient matrix H."""
        return self.h

    @property
    def reconstruction_err_(self):
        """sklearn alias: the final recorded objective value."""
        if self.results is None:
            return None
        return float(self.results.obj_history[-1])

    def factorize(self, method: str = "mur", saving: bool = False, **method_params):
        """Compute the factorization; keyword parameters go to the solver
        (param-file values first, overridden by explicit kwargs)."""
        if method not in _METHODS:
            raise Exception("Method not known. Choose one from: "
                            + " ".join(_METHODS))
        params = {**self.method_params, **method_params}

        from . import solvers

        # multilevel warm start (arXiv:1009.0881) rides any mur/hals fit:
        # factorize(method='hals', multilevel={'levels': 2, 'factor': 4}),
        # as tpunmf/api.py:102-116
        ml = params.pop("multilevel", None)
        if ml is not None:
            if method not in ("mur", "hals"):
                raise ValueError("multilevel= supports methods mur and hals")
            ml = dict(ml) if not isinstance(ml, bool) else {}
            mesh = params.pop("mesh", self.mesh)
            if mesh is not None:
                from .parallel import multilevel_mesh

                self.results = multilevel_mesh(self.data, self.factors, mesh, method=method,
                                               **ml, **params)
            else:
                self.results = solvers.multilevel(self.data, self.factors,
                                                  method=method, **ml, **params)
            print("Factorization done.")
            if saving:
                self.save_factorization()
            return self.results

        mask = beta = schedule = None
        mesh = params.pop("mesh", self.mesh)
        if method == "mur":
            # routing extensions, as tpunmf/api.py:122-129 (None is ignored)
            chosen = [n for n in ("schedule", "beta", "mask")
                      if params.get(n) is not None]
            if len(chosen) > 1:
                raise ValueError(
                    f"{' and '.join(chosen)} are mutually exclusive")
            mask = params.pop("mask", None)
            beta = params.pop("beta", None)
            schedule = params.pop("schedule", None)
            if schedule is not None and mesh is None:
                raise ValueError(
                    "schedule= requires a mesh (NMF(..., mesh=...) or "
                    "factorize(..., mesh=...))")

        if schedule is not None:
            from .parallel import mur_sharded

            self.results = mur_sharded(self.data, self.factors, mesh, schedule=schedule,
                                       **params)
        elif mesh is not None:
            from . import parallel

            if mask is not None:
                self.results = parallel.mur_masked_mesh(self.data, mask, self.factors, mesh,
                                                        **params)
            elif beta is not None:
                self.results = parallel.mur_beta_mesh(self.data, self.factors, mesh, beta=beta,
                                                      **params)
            else:
                self.results = getattr(parallel, _MESH_METHODS[method])(
                    self.data, self.factors, mesh, **params)
        elif method == "anls":
            self.results = solvers.anls(self.data, self.factors, **params)
        elif method == "hals":
            self.results = solvers.hals(self.data, self.factors, **params)
        elif method == "admm":
            self.results = solvers.admm(self.data, self.factors, **params)
        elif method == "ao_admm":
            self.results = solvers.ao_admm(self.data, self.factors, **params)
        elif method == "semi_nmf":
            # mixed-sign data, W free / H >= 0
            self.results = solvers.semi_nmf(self.data, self.factors, **params)
        elif method == "onmf":
            # orthogonality-constrained clustering NMF
            self.results = solvers.onmf(self.data, self.factors, **params)
        elif method == "robust":
            # l2,1-norm objective, outlier-resistant
            self.results = solvers.robust_nmf(self.data, self.factors, **params)
        elif method == "ntf":
            # native CP/PARAFAC for N-way data
            self.results = solvers.ntf(self.data, self.factors, **params)
        elif beta is not None:
            self.results = solvers.mur_beta(self.data, self.factors, beta=beta,
                                            **params)
        elif mask is not None:
            self.results = solvers.mur_masked(self.data, mask, self.factors,
                                              **params)
        else:
            self.results = solvers.mur(self.data, self.factors, **params)
        print("Factorization done.")
        if saving:
            self.save_factorization()
        return self.results

    def fit(self, method: str = "mur", **method_params) -> "NMF":
        """sklearn-style convenience: factorize and return self."""
        self.factorize(method=method, **method_params)
        return self

    def fit_transform(self, method: str = "mur", **method_params):
        """sklearn-style convenience: factorize and return W (the
        sample-by-component representation, as sklearn's NMF); for
        ``method='ntf'`` the mode-0 factor."""
        self.factorize(method=method, **method_params)
        return self.w if self.w is not None else self.results.factors[0]

    def transform(self, data, **opts):
        """Encode new data against the trained basis W (k x n_new), on
        ``data``'s device: EU exact batched NNLS, KL fixed-W MUR.  Defaults
        to the distance the model was trained with."""
        if self.results is None:
            raise RuntimeError("Nothing trained: call factorize() first.")
        if self.w is None:
            raise RuntimeError(
                "transform() needs a 2-D basis; the trained model is an "
                "N-way CP factorization (use its .factors directly).")
        from .solvers import transform as _transform

        trained = getattr(self.results.experiment, "distance_type", "eu")
        opts.setdefault("distance_type", trained if trained in ("eu", "kl") else "eu")
        return _transform(self.results.w, data, **opts)

    def inverse_transform(self, h):
        """Reconstruct data from coefficients: W @ h."""
        if self.results is None:
            raise RuntimeError("Nothing trained: call factorize() first.")
        if self.w is None:
            raise RuntimeError(
                "inverse_transform() needs a 2-D basis; the trained model "
                "is an N-way CP factorization (use cp_reconstruct on its "
                ".factors).")
        from .solvers import inverse_transform as _inv

        return _inv(self.results.w, h)

    def default_save_name(self) -> str:
        """Parameter-encoded save name, grammar-identical to nmf/nmf.py:95-126."""
        exp = self.results.experiment
        if exp.method == "ntf":
            return (f"ntf_{exp.components}_{exp.distance_type}_{exp.update}"
                    + "_" + "x".join(str(len(f)) for f in self.results.factors))
        save_name = f"nmf_{exp.method}"
        save_name += f"_{self.factors}"
        save_name += f"_{exp.distance_type}"
        if exp.method == "admm":
            save_name += f"_{exp.rho}"

        save_name += f"_{exp.lambda_w}"
        if exp.method in {"admm", "ao_admm"}:
            save_name += f":{exp.prox_w}"

        save_name += f"_{exp.lambda_h}"
        if exp.method in {"admm", "ao_admm"}:
            save_name += f":{exp.prox_h}"

        if exp.nndsvd_init[0]:
            save_name += f"_nndsvd{exp.nndsvd_init[1][0]}"
        else:
            save_name += "_random"

        if exp.method == "anls" and exp.fcnnls:
            save_name += "_fcnnls"
        return save_name

    def save_factorization(self, save_dir: str = "./results", save_name=None) -> str:
        """Save factorization to file (reference-compatible .npz layout)."""
        if self.results is None:
            raise RuntimeError("Nothing to save: call factorize() first.")
        os.makedirs(save_dir, exist_ok=True)
        if save_name is None:
            save_name = self.default_save_name()
        if getattr(self.results.experiment, "method", None) == "ntf":
            return save_ntf_results(
                os.path.join(save_dir, save_name),
                factors=self.results.factors,
                i=self.results.i,
                obj_history=self.results.obj_history,
                experiment=self.results.experiment._asdict(),
            )
        return save_results(
            os.path.join(save_dir, save_name),
            w=self.results.w,
            h=self.results.h,
            i=self.results.i,
            obj_history=self.results.obj_history,
            experiment=self.results.experiment._asdict(),
        )

    @classmethod
    def load_factorization(cls, path: str) -> "NMF":
        """Restore a saved factorization (ours or tpunmf's .npz).

        The experiment record is rebuilt as a namedtuple (files store it as
        a dict), so ``save_factorization`` / ``default_save_name`` work on
        a loaded model too.  An N-way file (``n_modes``) loads as
        ``NtfResults``."""
        ntf = is_ntf_file(path)
        payload = load_ntf_results(path) if ntf else load_results(path)
        experiment = payload["experiment"]
        if isinstance(experiment, dict):
            exp_cls = namedtuple("Experiment", list(experiment.keys()))
            experiment = exp_cls(**experiment)
        if ntf:
            from .solvers.ntf import NtfResults

            obj = cls(data=None, factors=payload["factors"][0].shape[1])
            obj.results = NtfResults(factors=payload["factors"], i=payload["i"],
                                     obj_history=payload["obj_history"],
                                     experiment=experiment)
            return obj
        obj = cls(data=None, factors=payload["w"].shape[1])
        obj.results = Results(
            w=payload["w"],
            h=payload["h"],
            i=payload["i"],
            obj_history=payload["obj_history"],
            experiment=experiment,
        )
        return obj
