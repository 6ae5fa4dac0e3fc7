"""Public facade: the ``NMF`` class, as in ``tpunmf.api``.

Same surface as ``tpunmf.NMF`` for what is ported: ``NMF(data, factors,
saving=True, param_file=None)``, ``.w`` / ``.h``, ``factorize``,
``default_save_name`` (the reference's file-name grammar,
nmf/nmf.py:95-126), ``save_factorization`` and ``load_factorization``.
Ported: ``method="mur"`` (with ``mask=`` for masked/weighted MUR) and
``method="hals"``; the other known methods and the routing extensions
``schedule=``, ``beta=``, ``multilevel=`` and ``mesh=`` raise
``NotImplementedError``.
"""
from __future__ import annotations

import os
from collections import namedtuple
from importlib import import_module

from .core.types import Results
from .io.npz import load_results, save_results

# tpunmf's dispatch list, kept whole so an unknown method fails the same way
_METHODS = ("mur", "anls", "admm", "ao_admm", "hals", "semi_nmf", "onmf",
            "ntf", "robust")
_PORTED = ("mur", "hals")
_UNPORTED_OPTIONS = ("schedule", "beta", "multilevel", "mesh")


class NMF:
    """Non-negative matrix factorization (MUR, masked MUR and HALS ported).

    Example:
        >>> from tpunmf_torch import NMF
        >>> model = NMF(torch.as_tensor(data, device="cuda"), factors)
        >>> model.factorize(method="mur", **method_params)
        >>> print(model.w, model.h)
    """

    def __init__(self, data=None, factors=None, saving=True, param_file=None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: multi-GPU solvers are not ported yet (ROADMAP.md)")
        self.data = data
        self.factors = factors
        self.saving = saving
        self.results = None
        self.method_params = {}

        if param_file is not None:
            try:
                parameters = import_module(param_file)
            except ImportError:
                print("No parameter file found.")
                return
            self.method_params = dict(parameters.method_params)

    @property
    def w(self):
        return None if self.results is None else self.results.w

    @property
    def h(self):
        return None if self.results is None else self.results.h

    def factorize(self, method: str = "mur", saving: bool = False, **method_params):
        """Compute the factorization; keyword parameters go to the solver
        (param-file values first, overridden by explicit kwargs)."""
        if method not in _METHODS:
            raise Exception("Method not known. Choose one from: "
                            + " ".join(_METHODS))
        if method not in _PORTED:
            raise NotImplementedError(
                f"method {method!r} is not ported yet; ported: "
                + " ".join(_PORTED))
        params = {**self.method_params, **method_params}
        mask = None
        if method == "mur":
            # routing extensions, as tpunmf/api.py:122-129 (None is ignored)
            chosen = [n for n in ("schedule", "beta", "mask")
                      if params.get(n) is not None]
            if len(chosen) > 1:
                raise ValueError(
                    f"{' and '.join(chosen)} are mutually exclusive")
            mask = params.pop("mask", None)
        for opt in _UNPORTED_OPTIONS:
            if params.pop(opt, None) is not None:
                raise NotImplementedError(f"{opt}= is not ported yet")

        from . import solvers

        if method == "hals":
            self.results = solvers.hals(self.data, self.factors, **params)
        elif mask is not None:
            self.results = solvers.mur_masked(self.data, mask, self.factors,
                                              **params)
        else:
            self.results = solvers.mur(self.data, self.factors, **params)
        print("Factorization done.")
        if saving:
            self.save_factorization()
        return self.results

    def default_save_name(self) -> str:
        """Parameter-encoded save name, grammar-identical to nmf/nmf.py:95-126."""
        exp = self.results.experiment
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
        a loaded model too."""
        payload = load_results(path)
        experiment = payload["experiment"]
        if isinstance(experiment, dict):
            exp_cls = namedtuple("Experiment", list(experiment.keys()))
            experiment = exp_cls(**experiment)
        obj = cls(data=None, factors=payload["w"].shape[1])
        obj.results = Results(
            w=payload["w"],
            h=payload["h"],
            i=payload["i"],
            obj_history=payload["obj_history"],
            experiment=experiment,
        )
        return obj
