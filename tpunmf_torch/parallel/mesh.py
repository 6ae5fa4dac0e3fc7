"""Device meshes over ``torch.distributed`` and the canonical NMF layouts.

The port's copy of ``tpunmf.parallel.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
``tpunmf``'s axis names:

  'rows' — data-parallel axis over V's row (user/sample) blocks;
  'cols' — V's column (item) blocks;
  'rank' — the k components (the rank schedule).

One process drives one device.  :func:`axis_size`, :func:`axis_index` and
:func:`axis_group` are the counterparts of ``mesh.shape[axis]``,
``lax.axis_index(axis)`` and the axis a ``psum`` runs over.  A layout is a
tuple with one entry a dimension, the axis that dimension splits over or
None, as ``PartitionSpec`` names it; :func:`local_block` cuts this rank's
block of a global array by it.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..core.device import as_input


def default_backend() -> str:
    """gloo for CPU tensors, and NCCL for CUDA tensors where the build has
    it, in one process group."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def local_cuda_index() -> int:
    """The card this rank works on: ``LOCAL_RANK`` (torchrun), else the
    global rank modulo the cards of the host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % torch.cuda.device_count()


def build_mesh(shape: Optional[Sequence[int]] = None,
               axis_names: Sequence[str] = ("rows", "cols"),
               device_type: str = "cuda"):
    """A mesh over every rank of the process group.

    Default shape: a 2-D ('rows', 'cols') mesh with a near-square
    factorization (rows <= cols, power-of-two split), as ``tpunmf``'s.
    ``device_type`` "cuda" (the default: rank r works on
    :func:`local_cuda_index`, its collectives on NCCL) or "cpu" (gloo),
    which is how a caller asks for the CPU.  A "cuda" mesh without a card
    raises.  Without a process group, one of a single rank is brought up
    in this process.
    """
    if device_type not in ("cuda", "cpu"):
        raise ValueError("device_type must be 'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpunmf_torch runs on the CUDA device, and none is available; to run on "
            "the CPU, build the mesh with device_type='cpu'")
    if not dist.is_initialized():
        dist.init_process_group(default_backend(), store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if shape is None:
        rows = 2 ** (int(math.log2(n)) // 2) if n & (n - 1) == 0 else 1
        shape = (rows, n // rows)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(local_cuda_index())
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names[: len(shape)]))


def has_axis(mesh, axis: str) -> bool:
    return axis in (mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """``mesh.shape[axis]``."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def nmf_shardings(mesh):
    """Canonical NMF layouts of (V, W, H) on a mesh.

    V: ('rows', 'cols') — both axes blocked;
    W: ('rows', None)   — row-sharded with V's rows, replicated over cols;
    H: (None, 'cols')   — column-sharded with V's cols, replicated over rows.

    On a 1-D ('cols',) mesh this is the north-star layout (V, H
    column-sharded; W fully replicated).  An axis the mesh lacks is None.
    """
    rows = "rows" if has_axis(mesh, "rows") else None
    cols = "cols" if has_axis(mesh, "cols") else None
    return dict(v=(rows, cols), w=(rows, None), h=(None, cols), replicated=(None, None))


def rank_shardings(mesh):
    """Rank-sharded layout for very large k: W (rows, 'rank'), H ('rank',
    None), V replicated or row-sharded.  Needs a mesh with a 'rank' axis."""
    if not has_axis(mesh, "rank"):
        raise ValueError("rank_shardings needs a mesh with a 'rank' axis")
    rows = "rows" if has_axis(mesh, "rows") else None
    return dict(v=(rows, None), w=(rows, "rank"), h=("rank", None), replicated=(None, None))


def local_block(mesh, a, layout):
    """This rank's block of the global array ``a`` (numpy or tensor) under
    ``layout``: a view where ``a`` allows one."""
    index = []
    for dim, axis in enumerate(layout):
        if axis is None:
            index.append(slice(None))
            continue
        p, size = axis_size(mesh, axis), a.shape[dim]
        if size % p:
            raise ValueError(f"dimension {dim} of size {size} does not divide the "
                             f"'{axis}' axis ({p})")
        block = size // p
        c = axis_index(mesh, axis)
        index.append(slice(c * block, (c + 1) * block))
    return a[tuple(index)]


def place(mesh, a, layout, dtype=None) -> torch.Tensor:
    """This rank's block of global ``a`` on the mesh's device, by
    ``as_input``'s dtype rule (a tensor keeps its dtype; other input is
    float32 on a card where it was float64)."""
    return as_input(local_block(mesh, a, layout), dtype=dtype,
                    device=mesh_device(mesh)).contiguous()


def shard_problem(mesh, v, w=None, h=None):
    """This rank's blocks of (v, w, h) in the canonical layouts."""
    sh = nmf_shardings(mesh)
    out = [place(mesh, v, sh["v"])]
    if w is not None:
        out.append(place(mesh, w, sh["w"]))
    if h is not None:
        out.append(place(mesh, h, sh["h"]))
    return tuple(out) if len(out) > 1 else out[0]
