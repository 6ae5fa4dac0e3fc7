"""Sparse-matrix panel streaming: blocked CSR -> dense tiles.

The port's copy of ``tpunmf.data.sparse_panels``.  Tiles of a CSR matrix
are densified on the host by the native C++ panelizer (``native/``,
multithreaded; every thread zeroes and fills its own rows; ragged edge
tiles too, into the full-size buffer), or by scipy where it could not be
built (``PanelStream.native`` says which), and staged to the device by
``data/pipeline.py``.  A buffer that holds the stream's previous tile
takes the next one for the cost of the two tiles' nonzeros (``holds=``):
the panelizer clears the old nonzeros instead of zeroing the buffer.
bfloat16 tiles are ``torch.bfloat16`` tensors: the panelizer writes their
bits straight into the tensor's buffer, and the scipy path rounds with
torch (round to nearest even, NaN quieted as the panelizer quiets it,
:func:`to_bf16`).
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np
import torch

from ..native import get_panelizer

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U16P = ctypes.POINTER(ctypes.c_uint16)


def _as_csr(matrix):
    import scipy.sparse as sp

    csr = matrix.tocsr() if not sp.isspmatrix_csr(matrix) else matrix
    csr.sort_indices()
    return csr


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16, round to nearest even, as the panelizer rounds:
    a NaN keeps its sign and high payload bits with the quiet bit set
    (torch's own cast makes every NaN 0x7FC0)."""
    out = x.to(torch.bfloat16)
    nan = torch.isnan(x)
    if bool(nan.any()):
        quiet = ((x.view(torch.int32) >> 16) | 0x40).to(torch.int16).view(torch.bfloat16)
        out = torch.where(nan, quiet, out)
    return out


class PanelStream:
    """Iterate dense (row_block x col_panel) tiles of a sparse CSR matrix.

    Args:
      matrix: scipy sparse matrix (any format; converted to CSR).
      row_block: tile height (rows per panel), clamped to m.
      col_panel: tile width (columns per panel), clamped to n.
      n_threads: host threads for the native densifier.
    """

    def __init__(self, matrix, row_block: int = 4096, col_panel: int = 4096,
                 n_threads: int | None = None):
        self.csr = _as_csr(matrix)
        self.m, self.n = self.csr.shape
        self.row_block = min(row_block, self.m)
        self.col_panel = min(col_panel, self.n)
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self._lib = get_panelizer()
        self._indptr = np.ascontiguousarray(self.csr.indptr, dtype=np.int64)
        self._indices = np.ascontiguousarray(self.csr.indices, dtype=np.int32)
        self._data = np.ascontiguousarray(self.csr.data, dtype=np.float32)
        # densification counter: lets tests assert the streaming solvers
        # read each block exactly once per pass (no redundant densifies)
        self.densify_count = 0

    @property
    def native(self) -> bool:
        """Whether the tiles go through the native panelizer (False: the
        scipy path, where it could not be built)."""
        return self._lib is not None

    @property
    def grid(self) -> tuple[int, int]:
        rb = -(-self.m // self.row_block)
        cb = -(-self.n // self.col_panel)
        return rb, cb

    def _span(self, i, j):
        row0, col0 = i * self.row_block, j * self.col_panel
        return row0, min(self.row_block, self.m - row0), col0, min(self.col_panel,
                                                                   self.n - col0)

    def _csr_args(self):
        return (self._indptr.ctypes.data_as(_I64P), self._indices.ctypes.data_as(_I32P),
                self._data.ctypes.data_as(_F32P))

    def _check_out(self, shape, dtype, out_dtype, contiguous):
        if tuple(shape) != (self.row_block, self.col_panel) or dtype != out_dtype \
                or not contiguous:
            raise ValueError(f"out must be a C-contiguous ({self.row_block}, "
                             f"{self.col_panel}) {out_dtype} buffer")

    def _native_tile(self, entry, i, j, ptr, holds):
        """Tile (i, j) into the (row_block, col_panel) buffer at ``ptr``
        through the panelizer's ``entry``: its rows zeroed first (the rows
        below a ragged tile are the caller's), or, where the buffer holds
        tile ``holds`` exactly, that tile's nonzeros cleared instead."""
        indptr, indices, data = self._csr_args()
        if holds is not None:
            entry(indptr, indices, None, *self._span(*holds), self.col_panel, 0, ptr,
                  self.n_threads)
        entry(indptr, indices, data, *self._span(i, j), self.col_panel,
              int(holds is None), ptr, self.n_threads)

    def panel(self, i: int, j: int, out: np.ndarray | None = None,
              holds: tuple[int, int] | None = None) -> np.ndarray:
        """Densify tile (i, j) as float32; edge tiles are zero-padded to full
        size.  ``out``, where given, is written and returned; ``holds`` says
        that ``out`` holds that tile of this stream exactly (as this stream
        wrote it), so the native panelizer clears its nonzeros in place of
        zeroing the whole buffer."""
        row0, rows, col0, cols = self._span(i, j)
        self.densify_count += 1
        if out is None:
            out = np.empty((self.row_block, self.col_panel), dtype=np.float32)
            holds = None
        else:
            self._check_out(out.shape, out.dtype, np.float32, out.flags.c_contiguous)
        if self._lib is None:
            out[:] = 0.0
            out[:rows, :cols] = self.csr[row0:row0 + rows, col0:col0 + cols].toarray()
            return out
        self._native_tile(self._lib.csr_tile_f32, i, j, out.ctypes.data_as(_F32P), holds)
        if holds is None:
            out[rows:] = 0.0
        return out

    def panel_bf16(self, i: int, j: int, out: torch.Tensor | None = None,
                   holds: tuple[int, int] | None = None) -> torch.Tensor:
        """Densify tile (i, j) as a CPU ``torch.bfloat16`` tensor (RNE);
        ``out`` and ``holds`` as in :meth:`panel`.

        The transfer-compression path: it halves host->device bytes.  The
        native path rounds during densification (no extra host pass); the
        scipy path densifies float32, then rounds once."""
        if out is None:
            out = torch.empty((self.row_block, self.col_panel), dtype=torch.bfloat16)
            holds = None
        else:
            self._check_out(out.shape, out.dtype, torch.bfloat16,
                            out.device.type == "cpu" and out.is_contiguous())
        if self._lib is None:
            return out.copy_(to_bf16(torch.from_numpy(self.panel(i, j))))
        self.densify_count += 1
        self._native_tile(self._lib.csr_tile_bf16, i, j, ctypes.cast(out.data_ptr(), _U16P),
                          holds)
        if holds is None:
            out[self._span(i, j)[1]:] = 0.0
        return out

    def panel_nnz(self, i: int, j: int) -> int:
        """Nonzero count of a tile (lets schedulers skip empty panels)."""
        row0, rows, col0, cols = self._span(i, j)
        if self._lib is not None:
            return int(self._lib.csr_panel_nnz(*self._csr_args()[:2], row0, rows, col0, cols))
        return int(self.csr[row0:row0 + rows, col0:col0 + cols].nnz)

    def __iter__(self) -> Iterator[tuple[int, int, np.ndarray]]:
        """Iterate (i, j, panel) tiles.

        NOTE: yields views of two rotating host buffers, so the caller must
        consume (copy or synchronously transfer) each panel before advancing
        the iterator twice, or take its own copy.  For random access without
        aliasing use :meth:`panel` with ``out=None``.
        """
        rb, cb = self.grid
        bufs = [np.empty((self.row_block, self.col_panel), dtype=np.float32)
                for _ in range(2)]
        held = [None, None]
        s = 0
        for i in range(rb):
            for j in range(cb):
                yield i, j, self.panel(i, j, out=bufs[s], holds=held[s])
                held[s] = (i, j)
                s ^= 1


def densify(matrix) -> np.ndarray:
    """Whole-matrix densification through the panel path, as float32."""
    stream = PanelStream(matrix)
    out = np.empty((stream.m, stream.n), dtype=np.float32)  # the tiles cover it
    for i, j, panel in stream:
        row0, rows, col0, cols = stream._span(i, j)
        out[row0:row0 + rows, col0:col0 + cols] = panel[:rows, :cols]
    return out
