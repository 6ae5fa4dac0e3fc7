"""Where a solver step's global sums come from.

A solver step written once runs on one device and over a mesh.  On one
device every array is whole, so each hook here is the identity (or the
plain norm): :data:`LOCAL`, the default of every step that takes
``sums=``.  Over a mesh (``parallel/mesh_solvers.MeshSums``) each rank
holds blocks, and a hook all-reduces a partial sum over the mesh axes
that split it.

The axes are named by their role in the step's frame: ``"rows"`` splits
the rows of the step's V (and of W), ``"cols"`` its columns (and H's).  A
step that works on the transposed problem (AO-ADMM's W subproblem on
V^T) takes ``sums.T``, which swaps the two roles.
"""
from __future__ import annotations

import torch


class Sums:
    """One device: every array whole, every hook the identity."""

    def psum(self, t, *over):
        """``t`` summed over the ranks of the axes ``over``: ``t`` is a
        fresh partial sum (a product, a reduction) of this rank's blocks."""
        return t

    def norms(self, ts, *over):
        """The 2-norms of the whole arrays whose blocks split over ``over``
        (over a mesh, one all_reduce for all of them)."""
        return tuple(torch.linalg.vector_norm(t) for t in ts)

    def numel(self, t, *over) -> int:
        """The number of elements of the whole array."""
        return t.numel()

    def whole(self, fn, over: str, *arrays):
        """``fn`` of arrays whose columns (dim 1) split over ``over``, where
        ``fn`` couples the entries of a row (a sort along it): this rank's
        columns of ``fn`` of the whole rows."""
        return fn(*arrays)

    @property
    def T(self) -> "Sums":
        """The same sums in the transposed frame (rows and cols swapped)."""
        return self


LOCAL = Sums()
