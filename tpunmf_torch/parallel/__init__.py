"""Solvers across devices over ``torch.distributed``: the port of ``tpunmf.parallel``.

The SPMD convention.  ``tpunmf`` runs one process over many devices and
hands around global sharded arrays; ``torch.distributed`` runs one
process a device.  So:

* **Mesh.** A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
  ``tpunmf``'s axis names ('rows', 'cols', 'rank') as its
  ``mesh_dim_names`` (``mesh.build_mesh``).  ``mesh.axis_size``,
  ``axis_index`` and ``axis_group`` stand for ``mesh.shape[axis]``,
  ``lax.axis_index`` and the axis of a ``psum``.
* **Backend and device.** A "cuda" mesh is the default: NCCL, rank r on
  ``cuda:LOCAL_RANK`` (or r modulo the host's cards without torchrun).
  A "cpu" mesh (gloo) is how a caller asks for the CPU.  A "cuda" mesh
  without a card raises; nothing falls back to the CPU.
  ``initialize_multihost`` brings up a group for both (gloo for CPU
  tensors, NCCL for CUDA ones); ``build_mesh`` brings up a world of one
  where no group exists.
* **The collectives level.** ``collectives.*``, ``mur_ulysses`` and
  ``mur_rank_sharded`` take and return the rank's local blocks, in the
  layout ``nmf_shardings`` / ``rank_shardings`` name (a tuple of axis
  names, one a dimension): what ``shard_map``'s body sees in ``tpunmf``.
* **The drivers.** ``mur_sharded``, ``mur_mesh`` (the facade's ``mesh=``),
  ``solvers.mur_streaming_sharded`` and ``serve.topk``'s ``mesh=`` keep
  ``tpunmf``'s contract: every rank passes the global host data, keeps
  its block, and gets the same result, the factors gathered to the host.
* **Same decision on every rank.** Every stop is decided from a value all
  ranks hold bit for bit: an all-reduced objective.
* **Same start on every rank.** Random and NNDSVD inits are made once, on
  rank 0, by the port's seeded rule, and broadcast.
* **Counts.** Every collective counts its calls by kind in
  ``collectives.calls`` (``reset_calls()``), as each kernel wrapper counts
  its launches.

The other solvers (``mesh_solvers``): ``hals_mesh``, ``anls_mesh``,
``admm_mesh``, ``ao_admm_mesh``, ``mur_masked_mesh``, ``mur_beta_mesh``,
``semi_nmf_mesh``, ``onmf_mesh``, ``robust_mesh``, ``ntf_mesh`` (modes 0
and 1 split, ``tpunmf``'s facade layout) and ``multilevel_mesh``, the
facade's ``mesh=`` for every method, run the one-device solver's own step
on the rank's blocks with the products and norms all-reduced
(``core/sums.py``'s hooks, ``MeshSums``).  Each takes the one-device
solver's keywords, blocks and checkpoints included: ``MeshStore``
(``mesh_checkpoint.py``) saves a mesh run's state as the one-device
``.npz`` file of global arrays, or as a sharded DCP directory
(``checkpoint_backend="dcp"``).  ``ntf_sharded``: N-way CP on mode-0
slabs.
"""
from .collectives import (
    calls,
    gram_h,
    gram_h_rank,
    gram_w,
    reset_calls,
    reshard_cols_to_rows,
    reshard_rows_to_cols,
    ring_xht,
    ring_xht_rotate_h,
    wh_psum_rank,
    wtx_psum,
    xht_psum,
)
from .mesh import (axis_group, axis_index, axis_size, build_mesh, local_block, nmf_shardings,
                   rank_shardings, shard_problem)
from .multihost import (
    assemble_global_columns,
    assert_collective_consistency,
    global_mesh,
    host_local_column_range,
    initialize_multihost,
)
from .mesh_checkpoint import MeshStore
from .mesh_solvers import (MeshSums, admm_mesh, anls_mesh, ao_admm_mesh, hals_mesh,
                           mur_beta_mesh, mur_masked_mesh, multilevel_mesh, ntf_mesh, onmf_mesh,
                           robust_mesh, semi_nmf_mesh)
from .ntf_sharded import ntf_sharded
from .sharded_solvers import mur_mesh, mur_rank_sharded, mur_sharded, mur_ulysses

__all__ = [
    "build_mesh",
    "nmf_shardings",
    "shard_problem",
    "gram_h",
    "gram_w",
    "xht_psum",
    "wtx_psum",
    "ring_xht",
    "ring_xht_rotate_h",
    "reshard_rows_to_cols",
    "reshard_cols_to_rows",
    "mur_ulysses",
    "mur_rank_sharded",
    "ntf_sharded",
    "mur_sharded",
    "wh_psum_rank",
    "gram_h_rank",
    "rank_shardings",
    "initialize_multihost",
    "global_mesh",
    "host_local_column_range",
    "assemble_global_columns",
    "assert_collective_consistency",
    # the port's own
    "mur_mesh",
    "hals_mesh",
    "anls_mesh",
    "admm_mesh",
    "ao_admm_mesh",
    "mur_masked_mesh",
    "mur_beta_mesh",
    "semi_nmf_mesh",
    "onmf_mesh",
    "robust_mesh",
    "ntf_mesh",
    "multilevel_mesh",
    "MeshSums",
    "MeshStore",
    "calls",
    "reset_calls",
    "axis_size",
    "axis_index",
    "axis_group",
    "local_block",
]
