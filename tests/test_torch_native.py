"""tpunmf_torch's PanelStream and native panelizer against tpunmf's, on the CPU.

Ragged tile grids of a ``sparse_csr`` matrix: every tile, its zero
padding, ``panel_nnz``, ``densify`` and the bfloat16 tiles are ``tpunmf``'s
bit for bit (``tpunmf``'s bf16 tiles are ``ml_dtypes`` arrays, the port's
``torch.bfloat16`` tensors); the scipy path agrees with the native one; a
buffer handed in is written whole; the loader builds, rebuilds on a newer
source, and records a failed build.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpunmf.data import PanelStream as JPanelStream
from tpunmf.data import densify as jdensify
from tpunmf_torch.data import PanelStream, densify, sparse_csr
from tpunmf_torch.native import get_panelizer, loader, native_available

GRIDS = [(300, 200), (256, 256), (128, 600), (1000, 1000)]


@pytest.fixture(scope="module")
def csr():
    return sparse_csr(777, 513, density=0.02, seed=9)


def _bits16(tile):
    """A bf16 tile's bits as uint16, from either package."""
    if isinstance(tile, torch.Tensor):
        return tile.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(tile).view(np.uint16)


def _tiles(stream):
    rb, cb = stream.grid
    return [(i, j) for i in range(rb) for j in range(cb)]


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_every_tile_is_tpunmf_s(csr, grid):
    got, want = PanelStream(csr, *grid), JPanelStream(csr, *grid)
    assert got.grid == want.grid and got.native == native_available()
    for i, j in _tiles(want):
        a, b = got.panel(i, j), want.panel(i, j)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
        assert got.panel_nnz(i, j) == want.panel_nnz(i, j)
    assert got.densify_count == want.densify_count == len(_tiles(want))


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_bf16_tiles_are_tpunmf_s_bits(csr, grid):
    got, want = PanelStream(csr, *grid), JPanelStream(csr, *grid)
    for i, j in _tiles(want):
        a, b = got.panel_bf16(i, j), want.panel_bf16(i, j)
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits16(a), _bits16(b))
    assert got.densify_count == want.densify_count


def test_edge_tiles_are_zero_padded(csr):
    ps = PanelStream(csr, row_block=256, col_panel=256)
    assert ps.grid == (4, 3)
    rows, cols = 777 - 3 * 256, 513 - 2 * 256
    for tile in (ps.panel(3, 2), ps.panel_bf16(3, 2).float().numpy(), ps.panel(3, 0)):
        assert tile.shape == (256, 256)
        assert not tile[rows:].any()
    last = ps.panel(3, 2)
    assert not last[:, cols:].any()
    np.testing.assert_array_equal(last[:rows, :cols], csr[3 * 256:, 2 * 256:].toarray())


def test_the_scipy_path_matches_the_native_one(csr):
    native, fallback = PanelStream(csr, 300, 200), PanelStream(csr, 300, 200)
    fallback._lib = None
    assert native.native and not fallback.native
    for i, j in _tiles(native):
        np.testing.assert_array_equal(native.panel(i, j), fallback.panel(i, j))
        np.testing.assert_array_equal(_bits16(native.panel_bf16(i, j)),
                                      _bits16(fallback.panel_bf16(i, j)))
        assert native.panel_nnz(i, j) == fallback.panel_nnz(i, j)
    assert native.densify_count == fallback.densify_count


def test_nan_is_quieted_as_the_panelizer_quiets_it():
    """Special values through both paths of both packages: NaN payloads
    keep their sign and high bits with the quiet bit set (torch's own cast
    would make every NaN 0x7FC0), ties round to even, inf stays inf."""
    bits = np.array([0x7FC00000, 0xFFC00000, 0x7FA00001, 0xFF800001, 0x7F800000,
                     0xFF800000, 0x3F808000, 0x3F818000, 0x3F80FFFF, 0x00000001,
                     0x7F7FFFFF, 0x3F800000], dtype=np.uint32)
    vals = bits.view(np.float32)
    dense = np.zeros((256, 16), dtype=np.float32)  # 256 rows: the threaded path
    dense[::21, 3][:len(vals)] = vals
    dense[5, 7] = 1.0
    mat = sp.csr_matrix(dense)
    got, fallback = PanelStream(mat, 256, 16), PanelStream(mat, 256, 16)
    want = JPanelStream(mat, 256, 16)
    fallback._lib = None
    a = _bits16(got.panel_bf16(0, 0))
    np.testing.assert_array_equal(a, _bits16(fallback.panel_bf16(0, 0)))
    np.testing.assert_array_equal(a, _bits16(want.panel_bf16(0, 0)))
    np.testing.assert_array_equal(
        a[::21, 3][:len(vals)],
        [0x7FC0, 0xFFC0, 0x7FE0, 0xFFC0, 0x7F80, 0xFF80, 0x3F80, 0x3F82, 0x3F81, 0x0000,
         0x7F80, 0x3F80])


def test_a_buffer_handed_in_is_written_whole(csr):
    ps = PanelStream(csr, 300, 200)
    for i, j in ((0, 0), (2, 1), (2, 2)):  # full, ragged rows, ragged rows and columns
        out = np.full((300, 200), np.nan, dtype=np.float32)
        assert ps.panel(i, j, out=out) is out
        np.testing.assert_array_equal(out, ps.panel(i, j))
        out16 = torch.full((300, 200), float("nan"), dtype=torch.bfloat16)
        assert ps.panel_bf16(i, j, out=out16) is out16
        np.testing.assert_array_equal(_bits16(out16), _bits16(ps.panel_bf16(i, j)))
    with pytest.raises(ValueError, match="C-contiguous"):
        ps.panel(0, 0, out=np.zeros((200, 300), dtype=np.float32))
    with pytest.raises(ValueError, match="C-contiguous"):
        ps.panel_bf16(0, 0, out=torch.zeros((300, 200), dtype=torch.float32))


def test_a_buffer_that_holds_a_tile_takes_the_next_by_its_nonzeros(csr):
    """``holds=``: the panelizer clears the held tile's nonzeros instead of
    zeroing the buffer; across every change of tile, ragged edges both
    ways, the buffer then equals a freshly densified tile, f32 and bf16."""
    ps = PanelStream(csr, 300, 200)
    tiles = _tiles(ps)
    order = tiles + tiles[::-1] + [(i, j) for j in range(3) for i in range(3)] + tiles[::2]
    out = np.full((300, 200), np.nan, dtype=np.float32)
    out16 = torch.full((300, 200), float("nan"), dtype=torch.bfloat16)
    held = None
    for ij in order:
        ps.panel(*ij, out=out, holds=held)
        ps.panel_bf16(*ij, out=out16, holds=held)
        np.testing.assert_array_equal(out, ps.panel(*ij))
        np.testing.assert_array_equal(_bits16(out16), _bits16(ps.panel_bf16(*ij)))
        held = ij


def test_densify_is_tpunmf_s(csr):
    np.testing.assert_array_equal(densify(csr), jdensify(csr))
    assert densify(csr).dtype == np.float32
    # COO with duplicate coordinates: they sum, as in scipy's CSR
    coo = sp.coo_matrix(([1.5, 2.25, 3.0], ([0, 0, 4], [1, 1, 2])), shape=(5, 3))
    np.testing.assert_array_equal(densify(coo), jdensify(coo))
    assert densify(coo)[0, 1] == 3.75


def test_iteration_is_tpunmf_s(csr):
    got = [(i, j, p.copy()) for i, j, p in PanelStream(csr, 300, 200)]
    want = [(i, j, p.copy()) for i, j, p in JPanelStream(csr, 300, 200)]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])


def test_the_loader_builds_rebuilds_and_records_a_failure(tmp_path, monkeypatch, csr):
    assert get_panelizer() is not None and native_available()
    so = tmp_path / "_build" / "_panelize.so"
    monkeypatch.setattr(loader, "_SO", str(so))
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_failed", False)
    lib = get_panelizer()
    assert lib is not None and so.exists()
    # a source newer than the library is built again
    os.utime(so, (1, 1))
    monkeypatch.setattr(loader, "_lib", None)
    assert get_panelizer() is not None and os.path.getmtime(so) > 1
    # a source that does not compile: no library, the message kept, and
    # PanelStream takes (and says it takes) the scipy path
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "_SRC", str(bad))
    monkeypatch.setattr(loader, "_SO", str(tmp_path / "other" / "_panelize.so"))
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "build_error", None)
    assert get_panelizer() is None and not native_available()
    assert "error" in loader.build_error
    ps = PanelStream(csr, 300, 200)
    assert not ps.native
    np.testing.assert_array_equal(ps.panel(1, 1), JPanelStream(csr, 300, 200).panel(1, 1))
