// Shared building blocks of the kernels (objective.cu, mur_update.cu,
// masked_update.cu; hals_sweep.cu uses only the launch helpers).
//
// Every kernel runs 256 threads as a 16 x 16 grid (ty, tx).  A thread owns a
// TM x TN micro-tile of a (16*TM) x (16*TN) block tile: rows ty + 16*a and
// columns tx + 16*b.  Products are f32 FMA from shared-memory tiles; the
// ragged edges of every operand are masked by loading zeros.  X is float or
// __nv_bfloat16 and is always read through to_f32(); factors are float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpunmf {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kChunk = 16;     // contraction depth staged per shared tile
constexpr float kEps = 1e-9f;  // the MUR guard of tpunmf/ops/mur_fused.py:38

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Launch a kernel of kThreads threads that needs `smem` bytes of dynamic
// shared memory; returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// out[0] = scale * sum(partials[0:count]), added in double in a fixed order by
// one block (objective.cu): cross-block sums without float atomics.
cudaError_t reduce_partials_into(const float* partials, int count, float scale, float* out,
                                 cudaStream_t stream);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(unsigned char v) { return (float)v; }

// One cell of the masked KL objective (tpunmf/core/losses.py:20-25): the log
// has no eps, +inf is zeroed before NaN, and -x + wh is added for every cell.
// Needs IEEE logf and division (no --use_fast_math).
__device__ __forceinline__ float kl_term(float xv, float wh) {
  float val = xv * logf(xv / wh);
  if (isinf(val) && val > 0.f) val = 0.f;
  if (isnan(val)) val = 0.f;
  return (val - xv) + wh;
}

// A factor value rounded to X's storage type (round to nearest even, as
// torch's .to(bfloat16)) and back: the EU kernels cast the factor to X's
// dtype before the product (tpunmf/ops/mur_fused.py:84, :716).
template <typename XT>
__device__ __forceinline__ float round_as_x(float v);
template <>
__device__ __forceinline__ float round_as_x<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_as_x<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc[a][b] += sum_{t < depth} A[t*lda + ty + 16a] * B[t*ldb + tx + 16b]
template <int TM, int TN>
__device__ __forceinline__ void micro_gemm(float (&acc)[TM][TN], const float* A, int lda,
                                           const float* B, int ldb, int depth, int ty,
                                           int tx) {
#pragma unroll 4
  for (int t = 0; t < depth; ++t) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[t * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = B[t * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Shared staging for wh_tile: As[kChunk][16*TM + 1], Bs[kChunk][16*TN + 1].
template <int TM, int TN>
struct WhStage {
  float a[kChunk * (16 * TM + 1)];
  float b[kChunk * (16 * TN + 1)];
};

// s = W[row0 : row0+16TM, :] @ H[:, col0 : col0+16TN] over the full rank k,
// zero outside the matrices.  W is (m, k), H is (k, n), both row-major.
// Contains __syncthreads(): every thread of the block must call it.
template <int TM, int TN>
__device__ __forceinline__ void wh_tile(float (&s)[TM][TN], const float* __restrict__ w,
                                        const float* __restrict__ h, int m, int n, int k,
                                        int row0, int col0, WhStage<TM, TN>& st) {
  constexpr int BM = 16 * TM, BN = 16 * TN, LDA = BM + 1, LDB = BN + 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  zero(s);
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    for (int l = tid; l < kChunk * BM; l += kThreads) {
      const int r = l / kChunk, kk = l % kChunk, gr = row0 + r, gk = k0 + kk;
      st.a[kk * LDA + r] = (gr < m && gk < k) ? w[(long long)gr * k + gk] : 0.f;
    }
    for (int l = tid; l < kChunk * BN; l += kThreads) {
      const int kk = l / BN, c = l % BN, gk = k0 + kk, gc = col0 + c;
      st.b[kk * LDB + c] = (gk < k && gc < n) ? h[(long long)gk * n + gc] : 0.f;
    }
    __syncthreads();
    micro_gemm<TM, TN>(s, st.a, LDA, st.b, LDB, kChunk, ty, tx);
    __syncthreads();
  }
}

}  // namespace tpunmf
