"""Multi-process bring-up and host-sharded data ingestion.

The port's copy of ``tpunmf.parallel.multihost``: the process group in
place of ``jax.distributed``, a mesh over every rank, and per-host
ingestion where each host materializes only its own column panel of V.
"""
from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_index, axis_size, build_mesh, default_backend, has_axis


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Bring up the process group (no-op for one process without an
    address, and for a second call).

    ``coordinator_address`` is "host:port" (TCP) or a URL
    (``tcp://...``, ``file://...``); without one, the rendezvous comes
    from torchrun's environment (``MASTER_ADDR``, ``WORLD_SIZE``...).
    ``backend`` defaults to gloo for CPU tensors and NCCL for CUDA ones.
    """
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and world == 1:
        return  # single-process run: nothing to do
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    dist.init_process_group(backend or default_backend(), init_method=init_method,
                            world_size=world, rank=rank)


def _gather_value(value) -> np.ndarray:
    """(world, size) float64: every rank's ``value``."""
    t = torch.as_tensor(value).detach().to("cpu", torch.float64).reshape(-1)
    if dist.get_backend() == "nccl":  # NCCL alone moves CUDA tensors only
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def assert_collective_consistency(value, *, rtol: float = 0.0) -> None:
    """Assert every rank computed the same (replicated) scalar: any
    divergence in collective results or a nondeterministic reduction shows
    up as ranks disagreeing on the global objective.  No-op for one
    process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    gathered = _gather_value(value)
    ref = gathered[0]
    for p in range(1, len(gathered)):
        if not np.allclose(ref, gathered[p], rtol=rtol, atol=0.0):
            raise AssertionError(
                f"host 0 and host {p} disagree on collective value: {ref} vs {gathered[p]}")


def global_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("rows", "cols"), device_type: str = "cuda"):
    """Mesh over every rank of every host."""
    return build_mesh(shape=shape, axis_names=axis_names, device_type=device_type)


def _hosts() -> list:
    """The host of each rank: ``rank // LOCAL_WORLD_SIZE`` where torchrun
    (or a caller) sets it, else the ranks' host names."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        per = int(os.environ["LOCAL_WORLD_SIZE"])
        return [r // per for r in range(dist.get_world_size())]
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names


def host_local_column_range(mesh, n: int) -> tuple[int, int]:
    """The [start, stop) slice of the item axis this host's ranks own.

    With H / V column-sharded over 'cols', each host only needs its own
    column panel of the data: the ingestion side of cross-host sharding.
    """
    if not has_axis(mesh, "cols"):
        return 0, n
    n_shards = axis_size(mesh, "cols")
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by cols={n_shards}")
    shard = n // n_shards
    hosts = _hosts()
    me = hosts[dist.get_rank()]
    cols_dim = list(mesh.mesh_dim_names).index("cols")
    ranks = mesh.mesh.cpu().numpy()
    local_ids = sorted({int(np.argwhere(ranks == r)[0][cols_dim])
                        for r in range(len(hosts)) if hosts[r] == me})
    return local_ids[0] * shard, (local_ids[-1] + 1) * shard


def assemble_global_columns(mesh, local_block, n: int):
    """This rank's (m, n / cols) column block of a global V that no host
    holds whole: each host passes only the columns in its
    :func:`host_local_column_range`, and each rank keeps its own block of
    them, as ``tpunmf``'s callback cuts it."""
    start, stop = host_local_column_range(mesh, n)
    if local_block.shape[1] != stop - start:
        raise ValueError(
            f"local block has {local_block.shape[1]} cols, host range is [{start}, {stop})")
    if not has_axis(mesh, "cols"):
        return local_block
    shard = n // axis_size(mesh, "cols")
    lo = axis_index(mesh, "cols") * shard - start
    return local_block[:, lo:lo + shard]

