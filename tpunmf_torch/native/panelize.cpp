// Blocked-CSR -> dense-tile panelizer (the host data path of out-of-core MUR).
//
// The card wants dense tiles; recommender-scale X arrives as CSR.  This host
// code densifies (row_block x col_panel) tiles out of a CSR matrix,
// multithreaded across rows, straight into the caller's buffer (in the port
// a pinned one, which the copy stream then moves to the device while the
// card computes on the tile before).  The C ABI of
// tpunmf/native/panelize.cpp:
//   csr_panel_f32: densify one tile into a caller-provided buffer.
//   csr_panel_f32_batch: densify a strip of column panels in one call.
//   csr_panel_bf16: densify one tile straight to bfloat16 (RNE).
//   csr_panel_nnz: nonzeros inside a tile.
// and the port's own:
//   csr_tile_f32, csr_tile_bf16: a (ragged) tile into rows ld elements
//   apart, zeroing them first or writing only nonzeros (or clearing them).
//
// Every thread zeroes its own rows of the tile, then fills them: one
// memset before the threads would set the pace of the whole out-of-core
// pass.  A buffer that holds the previous tile needs no zeroing at all:
// clearing that tile's nonzeros leaves it zero (PanelStream's ``holds=``),
// so a tile of a 1e-3-dense matrix costs its nonzeros, not its bytes.  The
// tiles are the same bits either way.
//
// Per-row column windows are located with binary search (indices sorted
// within each CSR row), so cost is O(rows * (log nnz_row + nnz_in_window))
// beyond the zeroing.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// float -> bfloat16 with round-to-nearest-even (the transfer-compression
// path: halves host->device panel bytes; the device computes in the
// factors' type)
inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, sizeof(x));
  // NaN guard: a payload confined to the low 16 bits would carry into
  // the exponent under RNE and come out as +/-inf; quiet it instead,
  // keeping the sign and the high payload bits (the port's scipy path,
  // sparse_panels.to_bf16, quiets the same way)
  if ((x & 0x7FFFFFFFu) > 0x7F800000u) {
    return static_cast<uint16_t>((x >> 16) | 0x0040u);
  }
  const uint32_t lsb = (x >> 16) & 1u;
  x += 0x7FFFu + lsb;
  return static_cast<uint16_t>(x >> 16);
}

inline void store(float* p, float v) { *p = v; }
inline void store(uint16_t* p, float v) { *p = f32_to_bf16(v); }

// Rows [r_begin, r_end) of the tile [row0, ...) x [col0, col0 + cols) into
// out, whose rows are ld >= cols elements apart.  With clear, each row is
// zeroed over its whole ld first (bf16 zero is 0x0000, so a byte-wise zero
// is exact); with data == nullptr the tile's nonzeros are written as 0,
// which clears a tile that out holds.
template <typename T>
void fill_tile_rows(const int64_t* indptr, const int32_t* indices,
                    const float* data, int64_t row0, int64_t r_begin,
                    int64_t r_end, int64_t col0, int64_t cols, int64_t ld,
                    bool clear, T* out) {
  if (clear) {
    std::memset(out + r_begin * ld, 0, sizeof(T) * (r_end - r_begin) * ld);
  }
  for (int64_t r = r_begin; r < r_end; ++r) {
    const int64_t row = row0 + r;
    const int32_t* beg = indices + indptr[row];
    const int32_t* end = indices + indptr[row + 1];
    // first nonzero with column >= col0
    const int32_t* lo =
        std::lower_bound(beg, end, static_cast<int32_t>(col0));
    const int32_t* hi =
        std::lower_bound(lo, end, static_cast<int32_t>(col0 + cols));
    T* out_row = out + r * ld;
    if (data == nullptr) {
      for (const int32_t* p = lo; p < hi; ++p) out_row[*p - col0] = T(0);
    } else {
      const float* vals = data + indptr[row];
      for (const int32_t* p = lo; p < hi; ++p) store(out_row + (*p - col0), vals[p - beg]);
    }
  }
}

void run_threaded(int64_t rows, int n_threads,
                  const std::function<void(int64_t, int64_t)>& body) {
  if (n_threads <= 1 || rows < 256) {
    body(0, rows);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(rows, b + chunk);
    if (b >= e) break;
    threads.emplace_back([&body, b, e] { body(b, e); });
  }
  for (auto& th : threads) th.join();
}

template <typename T>
void tile(const int64_t* indptr, const int32_t* indices, const float* data,
          int64_t row0, int64_t rows, int64_t col0, int64_t cols, int64_t ld,
          int clear, T* out, int n_threads) {
  run_threaded(rows, n_threads, [&](int64_t b, int64_t e) {
    fill_tile_rows(indptr, indices, data, row0, b, e, col0, cols, ld, clear != 0, out);
  });
}

}  // namespace

extern "C" {

// Densify the tile [row0, row0+rows) x [col0, col0+cols) into out
// (row-major rows x cols; every element of out is written).
void csr_panel_f32(const int64_t* indptr, const int32_t* indices,
                   const float* data, int64_t row0, int64_t rows,
                   int64_t col0, int64_t cols, float* out, int n_threads) {
  tile(indptr, indices, data, row0, rows, col0, cols, cols, 1, out, n_threads);
}

// Densify n_panels consecutive column panels (each rows x cols) for one
// row block into out (n_panels x rows x cols, contiguous).
void csr_panel_f32_batch(const int64_t* indptr, const int32_t* indices,
                         const float* data, int64_t row0, int64_t rows,
                         int64_t col0, int64_t cols, int64_t n_panels,
                         float* out, int n_threads) {
  run_threaded(rows, n_threads, [&](int64_t b, int64_t e) {
    for (int64_t p = 0; p < n_panels; ++p) {
      fill_tile_rows(indptr, indices, data, row0, b, e, col0 + p * cols, cols, cols, true,
                     out + p * rows * cols);
    }
  });
}

// Densify a tile directly to bfloat16 (round-to-nearest-even): the panel
// never exists as f32 on the host, so the transfer-compressed streaming
// path costs no extra host pass.
void csr_panel_bf16(const int64_t* indptr, const int32_t* indices,
                    const float* data, int64_t row0, int64_t rows,
                    int64_t col0, int64_t cols, uint16_t* out,
                    int n_threads) {
  tile(indptr, indices, data, row0, rows, col0, cols, cols, 1, out, n_threads);
}

// The tile into rows of out that are ld >= cols elements apart (a ragged
// tile inside a full-size buffer).  clear = 1 zeroes each of the tile's
// rows over ld first; clear = 0 writes only the tile's nonzeros, and with
// data == NULL writes them as 0, which clears a tile that out holds, so a
// buffer that held one tile takes the next for O(nonzeros) writes.
void csr_tile_f32(const int64_t* indptr, const int32_t* indices,
                  const float* data, int64_t row0, int64_t rows, int64_t col0,
                  int64_t cols, int64_t ld, int clear, float* out,
                  int n_threads) {
  tile(indptr, indices, data, row0, rows, col0, cols, ld, clear, out, n_threads);
}

void csr_tile_bf16(const int64_t* indptr, const int32_t* indices,
                   const float* data, int64_t row0, int64_t rows, int64_t col0,
                   int64_t cols, int64_t ld, int clear, uint16_t* out,
                   int n_threads) {
  tile(indptr, indices, data, row0, rows, col0, cols, ld, clear, out, n_threads);
}

// nnz inside a tile: lets the scheduler skip all-zero panels.
int64_t csr_panel_nnz(const int64_t* indptr, const int32_t* indices,
                      int64_t row0, int64_t rows, int64_t col0, int64_t cols) {
  int64_t total = 0;
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t row = row0 + r;
    const int32_t* beg = indices + indptr[row];
    const int32_t* end = indices + indptr[row + 1];
    const int32_t* lo =
        std::lower_bound(beg, end, static_cast<int32_t>(col0));
    const int32_t* hi =
        std::lower_bound(lo, end, static_cast<int32_t>(col0 + cols));
    total += hi - lo;
  }
  return total;
}

}  // extern "C"
