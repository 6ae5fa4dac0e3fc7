"""Where an entry point's data goes.

The port runs on the card unless the caller asks for the CPU: a
``torch.Tensor`` stays where it is (a CPU tensor is how a caller asks for
the CPU), and anything else (a numpy array, a memmap panel, a list) is
moved to the CUDA device.  Without a CUDA device such input raises: the
port never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def as_input(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device (or goes to
    ``device`` when one is given, as an input that follows another does);
    any other input goes to ``cuda``, or raises without a CUDA device."""
    if device is None and not isinstance(x, torch.Tensor):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpunmf_torch runs on the CUDA device, and none is available; "
                "to run on the CPU, pass a CPU torch.Tensor "
                "(torch.from_numpy(array))")
        device = torch.device("cuda")
    return torch.as_tensor(x, dtype=dtype, device=device)
