"""Carry state between ``tpunmf`` (JAX) and the port, as numpy arrays.

``tpunmf``'s factors, ``Results`` and ``LoopCarry`` fields become the
port's tensors on a given device and dtype, and back.  Nothing here
imports JAX: the JAX side hands over (or takes back) numpy arrays, e.g.
``np.asarray(jax_array)`` / ``jnp.asarray(numpy_array)``.  Also: an
``NtfResults``' factor list, and an ``OnlineNMF``'s stream state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import Results
from ..solvers.common import LoopCarry, host_array


def to_tensor(a, *, device=None, dtype=None) -> torch.Tensor:
    """An array (numpy or anything ``np.asarray`` takes) as a tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def carry_to_torch(carry, *, device=None, dtype=None) -> LoopCarry:
    """A loop carry with numpy-convertible fields (e.g. tpunmf's
    ``LoopCarry``) as the port's: factors (``inner``) on ``device`` in
    ``dtype``; i, obj, converged and obj_buf on the host as the port keeps
    them."""
    obj_buf = torch.as_tensor(np.array(carry.obj_buf))
    return LoopCarry(
        i=int(np.asarray(carry.i)),
        obj=torch.as_tensor(np.array(carry.obj), dtype=obj_buf.dtype),
        converged=bool(np.asarray(carry.converged)),
        obj_buf=obj_buf,
        inner=tuple(to_tensor(a, device=device, dtype=dtype)
                    for a in carry.inner),
    )


def carry_to_numpy(carry: LoopCarry) -> LoopCarry:
    """The port's carry with every field as numpy (for ``tpunmf``)."""
    return LoopCarry(
        i=np.int32(carry.i),
        obj=host_array(carry.obj),
        converged=np.bool_(carry.converged),
        obj_buf=host_array(carry.obj_buf),
        inner=tuple(host_array(a) for a in carry.inner),
    )


def results_to_torch(results, *, device=None, dtype=None) -> Results:
    """A ``Results`` record with w/h as tensors on ``device``."""
    return results._replace(w=to_tensor(results.w, device=device, dtype=dtype),
                            h=to_tensor(results.h, device=device, dtype=dtype))


def results_to_numpy(results) -> Results:
    """A ``Results`` record with w/h as numpy arrays."""
    return results._replace(w=host_array(results.w), h=host_array(results.h))


def ntf_results_to_torch(results, *, device=None, dtype=None):
    """An ``NtfResults`` record with its factor list as tensors on ``device``."""
    return results._replace(factors=[to_tensor(f, device=device, dtype=dtype)
                                     for f in results.factors])


def ntf_results_to_numpy(results):
    """An ``NtfResults`` record with its factor list as numpy arrays."""
    return results._replace(factors=[host_array(f) for f in results.factors])


def online_state(model) -> dict:
    """The stream state of either package's ``OnlineNMF`` as numpy: W, the
    statistics A and B, ``n_batches`` and the padded batch width."""
    return {"w": host_array(model._w), "a": host_array(model._a),
            "b": host_array(model._b), "n_batches": int(model.n_batches),
            "batch_width": int(model._batch_width)}


def set_online_state(model, state: dict) -> None:
    """Load :func:`online_state`'s dict (from either package) into the
    port's ``OnlineNMF``, on its device and in its dtype."""
    dev, dtype = model._w.device, model._w.dtype
    model._w, model._a, model._b = (to_tensor(state[n], device=dev, dtype=dtype).contiguous()
                                    for n in ("w", "a", "b"))
    model.n_batches = int(state["n_batches"])
    model._batch_width = int(state["batch_width"])
