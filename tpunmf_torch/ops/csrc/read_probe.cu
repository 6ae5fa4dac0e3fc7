// The read probe: the column sums of X + s, (1, n) f32, over 128-row strips.
//
// Replaces the Pallas kernel of bench.py's memory-rate probe (pallas_call
// bench.py:240, body `kern` :231): a STREAM-style read of an f32 X in
// strips, a per-column sum, and a scalar s that changes from call to call so
// that no call can be elided.
//
// What bounds it on the H100: bytes.  It reads m*n*4 bytes and does one add
// per byte read four; at 8192 x 8192 X is 268 MB, five times the 50 MB L2,
// so every call reads device memory (0.080 ms at 3.35 TB/s).  The design is
// a plain streaming read: each block sums one 128-row strip of 1024 columns,
// a thread four neighbouring columns by 16-byte loads (rows of X on 16
// bytes) with the strip's rows unrolled 8 deep, so enough loads are in
// flight to cover the memory latency, and writes the strip's partial; a
// second launch adds the m / 128 partials of each column in strip order.
// The TPU kernel carries its sum across the grid in order; here blocks run
// in parallel, so the partials and their fixed-order sum take its place: no
// float atomics, the same inputs give the same bits.  m must be a multiple
// of 128 (the TPU grid's strips); any n works.
#include "common.cuh"

namespace tpunmf {
namespace {

constexpr int kStrip = 128;              // rows of a strip (bench.py:229)
constexpr int kProbeCols = 4 * kThreads;  // columns of a block

// part[strip][c] = sum over the strip's rows r, in order, of (X[r][c] + s);
// grid (ceil(n / kProbeCols), m / kStrip).  vec: n % 4 == 0 and X on 16 bytes.
__global__ void __launch_bounds__(kThreads)
    strip_sums_kernel(const float* __restrict__ x, const float* __restrict__ s, int n, bool vec,
                      float* __restrict__ part) {
  const float sv = *s;
  const int c = blockIdx.x * kProbeCols + 4 * threadIdx.x;
  if (c >= n) return;
  const float* row = x + (long long)blockIdx.y * kStrip * n + c;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {  // c + 4 <= n, since n % 4 == 0
#pragma unroll 8
    for (int r = 0; r < kStrip; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(row + (long long)r * n);
      acc[0] += v.x + sv;
      acc[1] += v.y + sv;
      acc[2] += v.z + sv;
      acc[3] += v.w + sv;
    }
  } else {
    const int cols = min(4, n - c);
#pragma unroll 8
    for (int r = 0; r < kStrip; ++r)
      for (int q = 0; q < cols; ++q) acc[q] += row[(long long)r * n + q] + sv;
  }
  float* out = part + (long long)blockIdx.y * n + c;
  for (int q = 0; q < 4 && c + q < n; ++q) out[q] = acc[q];
}

// out[c] = part[0][c] + part[1][c] + ..., in strip order.
__global__ void __launch_bounds__(kThreads)
    strip_total_kernel(const float* __restrict__ part, int strips, int n,
                       float* __restrict__ out) {
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < n; c += gridDim.x * kThreads) {
    float v = 0.f;
    for (int i = 0; i < strips; ++i) v += part[(long long)i * n + c];
    out[c] = v;
  }
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// x f32 (m, n), m % 128 == 0; s a device float; part (m / 128, n) f32
// scratch; writes out (1, n) = the column sums of x + s.
int tpunmf_read_probe(const void* x, const void* s, int m, int n, void* part, void* out,
                      void* stream) {
  using namespace tpunmf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(xf) % 16 == 0;
  const int strips = m / kStrip;
  cudaError_t err = launch(strip_sums_kernel, dim3(ceil_div(n, kProbeCols), strips), 0, st, xf,
                           static_cast<const float*>(s), n, vec, static_cast<float*>(part));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(strip_total_kernel, dim3(ceil_div(n, kThreads)), 0, st,
                                 static_cast<const float*>(part), strips, n,
                                 static_cast<float*>(out)));
}

}  // extern "C"
