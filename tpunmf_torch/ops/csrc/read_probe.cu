// The read probe: the column sums of X + s, (1, n) f32, in one launch.
//
// Replaces the Pallas kernel of bench.py's memory-rate probe (pallas_call
// bench.py:240, body `kern` :231): a STREAM-style read of an f32 X in
// strips, a per-column sum, and a scalar s that changes from call to call so
// that no call can be elided.
//
// What bounds it on the H100: bytes.  It reads m*n*4 bytes and does one add
// per byte read four; at 8192 x 8192 X is 268 MB, five times the 50 MB L2,
// so every call reads device memory (0.080 ms at 3.35 TB/s).  The design is
// one streaming launch with no sum across blocks: a block owns a slab of 32
// columns over all m rows, 8 threads a row segment of 128 bytes (a float4
// each) and 32 row groups of them, group g on rows g, g + 32, g + 64, ...;
// a thread starts 8 16-byte loads before it adds any, so enough bytes are in
// flight to cover the memory latency (256 blocks at n = 8192, all resident
// at once).  The block then adds its 32 row groups' partials through shared
// memory in group order and writes its 32 columns.  The TPU kernel carries
// its sum across the grid in order; here each column's sum is one thread's
// rows in order, then the groups in order: no float atomics, and the same
// inputs give the same bits.  m must be a multiple of 128 (the TPU grid's
// strips); any n works (a slab past n, or X off 16 bytes, loads scalars).
#include "common.cuh"

namespace tpunmf {
namespace {

constexpr int kSlabVecs = 8;                      // float4 columns of a slab
constexpr int kSlabCols = 4 * kSlabVecs;           // 32 columns, 128 bytes a row
constexpr int kRowGroups = kThreads / kSlabVecs;  // 32
constexpr int kInFlight = 8;                      // loads of a thread before it adds

// out[c] = sum over rows r of (X[r][c] + s), c in the block's slab; grid
// ceil(n / kSlabCols).  vec: n % 4 == 0 and X on 16 bytes.
__global__ void __launch_bounds__(kThreads)
    column_sums_kernel(const float* __restrict__ x, const float* __restrict__ s, int m, int n,
                       bool vec, float* __restrict__ out) {
  __shared__ __align__(16) float part[kRowGroups][kSlabCols];
  const float sv = *s;
  const int q = threadIdx.x % kSlabVecs, g = threadIdx.x / kSlabVecs;
  const int c = blockIdx.x * kSlabCols + 4 * q;  // the thread's first column
  const int rows = m / kRowGroups;                // of a thread: a multiple of 4
  const long long stride = (long long)kRowGroups * n;
  const float* p = x + (long long)g * n + c;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec && c < n) {  // c + 4 <= n, since n % 4 == 0
#pragma unroll 1
    for (int i0 = 0; i0 < rows; i0 += kInFlight) {
      float4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        v[u] = i0 + u < rows ? __ldg(reinterpret_cast<const float4*>(p + (i0 + u) * stride))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (i0 + u < rows) {
          acc[0] += v[u].x + sv;
          acc[1] += v[u].y + sv;
          acc[2] += v[u].z + sv;
          acc[3] += v[u].w + sv;
        }
      }
    }
  } else if (c < n) {
    const int cols = min(4, n - c);
#pragma unroll 4
    for (int i = 0; i < rows; ++i)
      for (int k = 0; k < cols; ++k) acc[k] += p[i * stride + k] + sv;
  }
  *reinterpret_cast<float4*>(&part[g][4 * q]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (threadIdx.x < kSlabCols) {
    const int col = blockIdx.x * kSlabCols + threadIdx.x;
    float v = 0.f;
    for (int r = 0; r < kRowGroups; ++r) v += part[r][threadIdx.x];
    if (col < n) out[col] = v;
  }
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// x f32 (m, n), m % 128 == 0; s a device float; writes out (1, n) = the
// column sums of x + s, in one launch.
int tpunmf_read_probe(const void* x, const void* s, int m, int n, void* out, void* stream) {
  using namespace tpunmf;
  const float* xf = static_cast<const float*>(x);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(xf) % 16 == 0;
  return static_cast<int>(launch(column_sums_kernel, dim3(ceil_div(n, kSlabCols)), 0,
                                 static_cast<cudaStream_t>(stream), xf,
                                 static_cast<const float*>(s), m, n, vec,
                                 static_cast<float*>(out)));
}

}  // extern "C"
