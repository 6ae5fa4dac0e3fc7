"""Checkpoints of a mesh driver's state: the one-device files, from blocks.

A mesh driver carries the one-device solver's leaves in the same order
(``solvers/common.LoopCarry``), each split leaf as this rank's block.
:class:`MeshStore` is the ``store`` that ``solvers/common.run_loop``
saves and resumes through:

  * ``backend="npz"`` (the default): at a block boundary every split leaf
    is gathered to its global array (``all_gather`` over each mesh axis
    that splits it), rank 0 writes ``io/checkpoint.save_state``'s file,
    ``tpunmf``'s format, and every rank waits at a barrier; on resume
    every rank reads the file and keeps its own block.  So a checkpoint
    moves between a mesh run, a one-device run and ``tpunmf``, both ways,
    and between mesh shapes.
  * ``backend="dcp"``: ``io/checkpoint.save_state_dcp`` with each split
    leaf a ``DTensor`` of the rank's block; no gather.

A leaf keeps the layout it had (a column-major factor is saved and comes
back column-major), so a resumed run takes the products of the
uninterrupted one, and its bits.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..io.checkpoint import (_col_major, _global_shape, _unflatten, checkpoint_exists,
                             checkpoint_exists_dcp, flatten, load_state, load_state_dcp,
                             save_state, save_state_dcp)
from .collectives import all_gather
from .mesh import has_axis, local_block

# a LoopCarry's own leaves (i, obj, converged, obj_buf) are whole on every rank
_CARRY_LEAVES = 4


class MeshStore:
    """``run_loop``'s store over ``mesh``: ``inner`` holds one layout a
    leaf of the carry's ``inner`` in ``flatten``'s order (a tuple of axis
    names, or None for a leaf every rank holds whole)."""

    def __init__(self, mesh, inner, backend: str = "npz"):
        if backend not in ("npz", "dcp"):
            raise ValueError("checkpoint_backend must be 'npz' or 'dcp'")
        self.mesh = mesh
        self.backend = backend
        self.layouts = [None] * _CARRY_LEAVES + [self._present(lay) for lay in inner]

    def _present(self, layout):
        """``layout`` with the axes the mesh lacks as None; None where no
        axis is left."""
        if layout is None:
            return None
        kept = tuple(a if a is not None and has_axis(self.mesh, a) else None for a in layout)
        return kept if any(a is not None for a in kept) else None

    def exists(self, path) -> bool:
        return (checkpoint_exists_dcp if self.backend == "dcp" else checkpoint_exists)(path)

    def _gathered(self, leaf, layout):
        if layout is None:
            return leaf
        col = _col_major(leaf)
        t = leaf.T if col else leaf
        for dim, axis in enumerate(layout):
            if axis is not None:
                t = all_gather(t, self.mesh, axis, dim=1 - dim if col else dim)
        return t.T if col else t

    def save(self, path, carry, meta):
        if self.backend == "dcp":
            save_state_dcp(path, carry, meta, mesh=self.mesh, layouts=self.layouts)
            return
        leaves = [self._gathered(leaf, lay) for leaf, lay in zip(flatten(carry), self.layouts)]
        if dist.get_rank() == 0:
            save_state(path, _unflatten(carry, iter(leaves)), meta=meta)
        dist.barrier()

    def load(self, path, carry, meta):
        if self.backend == "dcp":
            return load_state_dcp(path, carry, meta, mesh=self.mesh, layouts=self.layouts)
        leaves = flatten(carry)
        template = []
        for leaf, lay in zip(leaves, self.layouts):
            if lay is None:
                template.append(leaf)
                continue
            template.append(torch.empty(_global_shape(self.mesh, lay, leaf.shape),
                                        dtype=leaf.dtype))
        whole = flatten(load_state(path, _unflatten(carry, iter(template)),
                                   expected_meta=meta))
        out = []
        for g, leaf, lay in zip(whole, leaves, self.layouts):
            if lay is None:
                out.append(g)
                continue
            block = local_block(self.mesh, g, lay).to(device=leaf.device, dtype=leaf.dtype)
            out.append(block.T.contiguous().T if _col_major(g) else block.contiguous())
        return _unflatten(carry, iter(out))
