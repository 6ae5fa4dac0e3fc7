"""Where an entry point's data goes, and in which type.

The port runs on the card unless the caller asks for the CPU: a
``torch.Tensor`` stays where it is (a CPU tensor is how a caller asks for
the CPU), and anything else (a numpy array, a memmap panel, a list) is
moved to the CUDA device.  Without a CUDA device such input raises: the
port never falls back to the CPU on its own.

Float64 input that is not a tensor becomes float32 on its way to the
card, as ``jnp.asarray`` makes it float32 in ``tpunmf`` (x64 is off by
default there).  A tensor keeps its dtype: a CUDA float64 tensor is how a
caller asks for float64 on the card (the plain route), and a CPU tensor
keeps its dtype, float64 included.
"""
from __future__ import annotations

import torch


def as_input(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device (or goes to
    ``device`` when one is given, as an input that follows another does)
    and its dtype; any other input goes to ``cuda``, or raises without a
    CUDA device, and float64 becomes float32 there unless ``dtype`` says
    otherwise."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=dtype, device=device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpunmf_torch runs on the CUDA device, and none is available; "
                "to run on the CPU, pass a CPU torch.Tensor "
                "(torch.from_numpy(array))")
        device = torch.device("cuda")
    host = torch.as_tensor(x)
    if dtype is None and host.dtype == torch.float64 and torch.device(device).type == "cuda":
        dtype = torch.float32
    return host.to(device=device, dtype=dtype)


def state_device(init, device=None) -> torch.device:
    """Where a solver's state lives when its data is not a tensor (a scipy
    matrix, a stream of minibatches): on ``init``'s device when that is a
    tensor, else on ``device`` (default ``cuda``; without a CUDA device this
    raises, as :func:`as_input` does)."""
    if isinstance(init, torch.Tensor):
        return init.device
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpunmf_torch runs on the CUDA device, and none is available; to run "
            "on the CPU, pass CPU torch.Tensor inits or device='cpu'")
    return dev
