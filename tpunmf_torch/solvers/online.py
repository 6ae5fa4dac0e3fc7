"""Online NMF — streaming minibatch learning with sufficient statistics, on PyTorch.

Same contract as ``tpunmf.solvers.online``: W is learned from a stream of
column minibatches in O(mk + k^2) state (Mairal et al., JMLR 2010,
specialized to NMF).  Per minibatch X_t (m, b):

  1. encode   H_t = argmin_{H>=0} ||X_t - W H||^2  (batched NNLS,
     ``nnls.nnls_activeset``, with ``cuda_defaults.anls_masked_solver``'s
     method, as ANLS and ``transform``);
  2. accumulate with forgetting factor rho:
         A <- rho A + H_t H_t^T          (k x k)
         B <- rho B + X_t H_t^T          (m x k)
  3. ``sweeps`` HALS sweeps over W's columns on the surrogate
     1/2 tr(W A W^T) - tr(W^T B): the batch HALS column rule with
     (X H^T, H H^T) replaced by (B, A), eps 1e-16.

Step 3 is HALS's Gauss-Seidel sweep in the transposed frame,
``gs_sweep(B^T, A, W^T, lam=0, nsweeps=sweeps)^T`` (ops/hals_sweep.py,
one launch a minibatch) where ``sweep_takes`` takes W (float32, k <= 1024),
else its plain version.  ``track_objective`` appends each minibatch's
mixed-iterate EU value, 0.5 ||X_t - W H_t||^2 with the post-sweep W and
the pre-sweep encode (one host read a minibatch).

The state lives on ``w_init``'s device when that is a tensor, else on
``device`` (default ``cuda``: without a card this raises, as
``core/device.as_input`` does; pass ``device="cpu"`` or a CPU ``w_init``
for a CPU run).  Minibatches follow the state's device.  The random W init
draws |N(0,1)| from a ``torch.Generator`` (``key``: a generator or an int
seed, default 0; torch's draws differ from ``jax.random``'s).
"""
from __future__ import annotations

import torch

from ..core.device import as_input, state_device
from ..core.precision import full_f32
from ..init.random import make_generator
from ..nnls import nnls_activeset
from ..ops.hals_sweep import gs_sweep, gs_sweep_ref, sweep_takes
from . import cuda_defaults
from .common import host_array

_EPS = 1e-12


class OnlineNMF:
    """Streaming NMF: ``partial_fit`` minibatches of columns, read ``.w``.

    Args:
      m: row count of the data (fixed across the stream).
      k: rank.
      rho: forgetting factor in (0, 1] — 1.0 accumulates all history
        (stationary streams); < 1 tracks drift.
      sweeps: HALS sweeps over W per minibatch.
      key: ``torch.Generator`` or int seed for the random W init (|N(0,1)|).
      w_init: explicit (m, k) initial basis.
      dtype: the state's dtype (float32 by default, as ``tpunmf``).
      track_objective: append each batch's EU objective to
        ``obj_history`` (a mixed-iterate diagnostic; see the module
        docstring).
      device: where the state lives when ``w_init`` is not a tensor.
      use_pallas: the sweep kernel on/off (default: on for a CUDA state).
    """

    def __init__(self, m: int, k: int, *, rho: float = 1.0,
                 sweeps: int = 2, key=None, w_init=None,
                 dtype=torch.float32, track_objective: bool = True,
                 device=None, use_pallas=None):
        if not 0.0 < rho <= 1.0:
            raise ValueError("rho must be in (0, 1]")
        self.k = k
        self.rho = float(rho)
        self.sweeps = int(sweeps)
        dev = state_device(w_init, device)
        if w_init is not None:
            w = as_input(w_init, dtype=dtype, device=dev)
            if tuple(w.shape) != (m, k):
                raise ValueError(f"w_init must be ({m}, {k}); got {tuple(w.shape)}")
        else:
            g = make_generator(key, dev)
            w = torch.randn((m, k), generator=g, dtype=dtype, device=g.device).abs_()
        self._w = w.contiguous()
        self._a = torch.zeros((k, k), dtype=dtype, device=dev)
        self._b = torch.zeros((m, k), dtype=dtype, device=dev)
        self.n_batches = 0
        self.obj_history: list = []
        self.track_objective = bool(track_objective)
        self._batch_width = 0
        self._solve_method = cuda_defaults.anls_masked_solver(dev)
        if use_pallas is None:
            use_pallas = dev.type == "cuda"
        self._sweep = gs_sweep if bool(use_pallas) and sweep_takes(w, k) else gs_sweep_ref

    @property
    def w(self):
        return host_array(self._w)

    def _step(self, x_t):
        w, k = self._w, self.k
        gram = w.T @ w + _EPS * torch.eye(k, dtype=w.dtype, device=w.device)
        h_t = nnls_activeset(gram, w.T @ x_t, solve_method=self._solve_method)
        self._a = self.rho * self._a + h_t @ h_t.T
        self._b = self.rho * self._b + x_t @ h_t.T
        # the surrogate's column update is the batch HALS sweep with
        # (XHt, HHt) -> (B, A), in the transposed frame
        self._w = self._sweep(self._b.T, self._a, w.T, lam=0.0, nsweeps=self.sweeps).T
        return h_t

    def partial_fit(self, x_t):
        """Consume one (m, b) column minibatch; returns its encode H_t.

        Ragged batches are zero-padded up to the widest batch seen so far
        (zero columns encode to exactly h = 0, so the statistics are
        unchanged), as ``tpunmf`` pads them."""
        x_t = as_input(x_t, dtype=self._w.dtype, device=self._w.device)
        if x_t.ndim != 2 or x_t.shape[0] != self._w.shape[0]:
            raise ValueError(
                f"minibatch must be ({self._w.shape[0]}, b); got {tuple(x_t.shape)}")
        width = x_t.shape[1]
        if width < self._batch_width:
            x_t = torch.nn.functional.pad(x_t, (0, self._batch_width - width))
        else:
            self._batch_width = width
        with torch.no_grad(), full_f32():
            h_t = self._step(x_t)
            self.n_batches += 1
            if self.track_objective:
                # post-sweep W against the pre-sweep encode
                d = x_t - self._w @ h_t
                self.obj_history.append(float(0.5 * torch.sum(d * d)))
        return h_t[:, :width]

    def transform(self, x_new, **opts):
        """Encode new columns against the current basis (default: exact
        EU NNLS; pass distance_type='kl' for the fixed-W KL encode)."""
        from .transform import transform as _transform

        opts.setdefault("distance_type", "eu")
        return _transform(self._w, x_new, **opts)


def online_nmf(batches, m: int, k: int, **kwargs) -> OnlineNMF:
    """Drive :class:`OnlineNMF` over an iterable of (m, b) minibatches."""
    model = OnlineNMF(m, k, **kwargs)
    for x_t in batches:
        model.partial_fit(x_t)
    return model
