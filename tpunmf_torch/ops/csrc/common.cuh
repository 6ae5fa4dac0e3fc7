// Shared building blocks of the kernels: the FMA tiles of mur_update.cu
// and mur_variants.cu (and through wave.cuh mur_iteration.cu and
// hals_iteration.cu); the launch helpers, the KL masking, the zero-first
// division and the cp.async staging for every kernel, the tensor-core ones
// of tf32x3.cuh included.
//
// Every kernel runs 256 threads (wave.cuh's TMA stages and topk_select.cu's
// scoring kernel: 384, launched by their own helpers).  The FMA kernels see
// them as a 16 x 16 grid (ty, tx): a thread owns a TM x TN micro-tile of a (16*TM) x (16*TN) block
// tile, rows ty + 16*a and columns tx + 16*b, its products f32 FMA from
// shared-memory tiles (tf32x3.cuh's kernels see 8 warps instead).  The
// ragged edges of every operand are masked by loading zeros.  X is float or
// __nv_bfloat16 and is always read through to_f32(); factors are float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// kl_term(x, wh) with x == 0 taken first: the term is then wh exactly
// ((0 * log(0 / wh) is NaN or 0, zeroed, and (0 - 0) + wh = wh), with no
// division or log; most cells of a sparse X take it (objective.cu, the
// lagged KL W pass of masked_update.cu).
__device__ __forceinline__ float kl_term_sparse(float xv, float wh) {
  return xv == 0.f ? wh : kl_term(xv, wh);
}

// a / b with a zero numerator answered first, bit for bit as IEEE
// division gives it (+-0 with the sign of a times b's; NaN where b is 0 or
// NaN, left to the division): the division's check sends a zero numerator
// down its slow path, which most cells of a sparse X would take.
__device__ __forceinline__ float div_zero_first(float a, float b) {
  if (a == 0.f && b != 0.f && !isnan(b))
    return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) & 0x80000000);
  return a / b;
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

// ------------------------------------------------ the MUR kernels' tile loops
// Shared by the 2-pass kernels (mur_update.cu), which run them over all of X,
// and the single-pass iteration (mur_iteration.cu), which runs them over a
// range of X's rows or columns.  Ranges start at multiples of kTile, so a
// tile never straddles two ranges; the edges of the matrices are masked.

constexpr int kTile = 64;  // 16 * 4: the EU tile, and the KL tile along the
                           // axis of X the loop walks
// k above this halves the KL block along the axis that holds all of k, so
// its accumulator stays near 130 KB of shared memory.
constexpr int kWideRank = 512;

// Rows of W (columns of H) a KL block owns at rank k.
inline int kl_block(int k) { return k <= kWideRank ? 64 : 32; }

// Staging of the 64 x 64 EU tiles: a[kChunk][kTile + 1], b[kChunk][kTile + 1].
struct EuStage {
  float a[kChunk * (kTile + 1)];
  float b[kChunk * (kTile + 1)];
};

// acc[a][b] += sum_{i0 <= i < i1} F[i][c0 + ty + 16a] * X[i][col0 + tx + 16b]
// with F (m, k) float rounded to X's type and X (m, n): a 64 x 64 tile of
// F^T X over the rows [i0, i1) of X (i1 <= m).
template <typename XT>
__device__ __forceinline__ void ft_x_tile(float (&acc)[4][4], const XT* __restrict__ x,
                                          const float* __restrict__ f, int n, int k, int col0,
                                          int c0, int i0, int i1, EuStage& st) {
  constexpr int LD = kTile + 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int ib = i0; ib < i1; ib += kChunk) {
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int kk = l / kTile, r = l % kTile, gi = ib + kk, gc = c0 + r;
      st.a[kk * LD + r] = (gi < i1 && gc < k) ? round_as_x<XT>(f[(long long)gi * k + gc]) : 0.f;
    }
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int kk = l / kTile, c = l % kTile, gi = ib + kk, gj = col0 + c;
      st.b[kk * LD + c] = (gi < i1 && gj < n) ? to_f32(x[(long long)gi * n + gj]) : 0.f;
    }
    __syncthreads();
    micro_gemm<4, 4>(acc, st.a, LD, st.b, LD, kChunk, ty, tx);
    __syncthreads();
  }
}

// --------------------------------------------------- cp.async staging
// Shared tiles of the tensor-core kernels (tf32x3.cuh, masked_update.cu)
// are filled by 16-byte cp.async copies, which do not pass through
// registers, so a staged row keeps X's layout and type.

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most the latest committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// Wait until every committed group of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// A 4-byte copy: *smem = valid ? *gmem : 0, gmem not read where !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ unsigned char zero_of<unsigned char>() { return 0; }

// Whether p starts on 16 bytes (a cp.async or vector access may start there).
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One 16-byte piece (V = 16 / sizeof(T) elements) of a staged tile:
// dst[v] = v < valid ? src[v] : 0.  A whole piece of an aligned row goes by
// cp.async; a ragged edge, or a row that does not start on 16 bytes (X with
// n % V != 0), by plain loads.  src is not read where valid <= 0.
template <typename T>
__device__ __forceinline__ void stage_piece(T* dst, const T* src, int valid, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  if (aligned && valid >= V) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = v < valid ? src[v] : zero_of<T>();
  }
}

// acc[a][b] += sum_kk W[row0 + ty + 16a][kk] * G[kk][c0 + tx + 16b] with W
// (m, k) and G (k, k): a 64 x 64 tile of W G (the EU W denominator).
__device__ __forceinline__ void w_g_tile(float (&acc)[4][4], const float* __restrict__ w,
                                         const float* __restrict__ g, int m, int k, int row0,
                                         int c0, EuStage& st) {
  constexpr int LD = kTile + 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int r = l / kChunk, kk = l % kChunk, gr = row0 + r, gk = k0 + kk;
      st.a[kk * LD + r] = (gr < m && gk < k) ? w[(long long)gr * k + gk] : 0.f;
    }
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int kk = l / kTile, c = l % kTile, gk = k0 + kk, gc = c0 + c;
      st.b[kk * LD + c] = (gk < k && gc < k) ? g[(long long)gk * k + gc] : 0.f;
    }
    __syncthreads();
    micro_gemm<4, 4>(acc, st.a, LD, st.b, LD, kChunk, ty, tx);
    __syncthreads();
  }
}

// Shared memory of the KL row loop: the S staging, P transposed
// (ps[t][r] = P[row0 + r][j + t]) and the H tile (ts[t][c] = H[c0 + c][j + t]).
template <int TM>
struct KlRowStage {
  WhStage<TM, 4> wh;
  float ps[kTile * (16 * TM + 1)];
  float ts[kTile * (kTile + 1)];
};

// The KL W-side loop over the columns [j0, j1) of X for the rows
// [row0, row0 + 16 TM): acc[r][c] += sum_j P[row0 + r][j] H[c][j], with
// P = X / (W H + eps) and acc row-major of stride lda (kpad + 1).  LAGGED:
// obj += the masked KL of (X, W H) over those cells, with the raw W H in the
// log (tpunmf/ops/mur_fused.py:134-138); one f32 sum per tile, added in double.
template <typename XT, int TM, bool LAGGED>
__device__ __forceinline__ void kl_rows(const XT* __restrict__ x, const float* __restrict__ w,
                                        const float* __restrict__ h, int m, int n, int k,
                                        int kpad, int row0, int j0, int j1, float* acc, int lda,
                                        double& obj, KlRowStage<TM>& st) {
  constexpr int TN = 4, BM = 16 * TM, BN = kTile, LDP = BM + 1, LDT = BN + 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int jt = j0; jt < j1; jt += BN) {
    float s[TM][TN];
    wh_tile<TM, TN>(s, w, h, m, n, k, row0, jt, st.wh);  // ends with a barrier
    float tile_obj = 0.f;
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b, gr = row0 + r, gc = jt + c;
        const bool in = gr < m && gc < n;
        const float xv = in ? to_f32(x[(long long)gr * n + gc]) : 0.f;
        st.ps[c * LDP + r] = in ? xv / (s[a][b] + kEps) : 0.f;
        if (LAGGED && in) tile_obj += kl_term(xv, s[a][b]);
      }
    }
    if (LAGGED) obj += tile_obj;
    for (int c0 = 0; c0 < kpad; c0 += BN) {
      for (int l = tid; l < BN * BN; l += kThreads) {
        const int cc = l / BN, t = l % BN, gk = c0 + cc, gc = jt + t;
        st.ts[t * LDT + cc] = (gk < k && gc < n) ? h[(long long)gk * n + gc] : 0.f;
      }
      __syncthreads();
      float part[TM][TN];
      zero(part);
      micro_gemm<TM, TN>(part, st.ps, LDP, st.ts, LDT, BN, ty, tx);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[(ty + 16 * a) * lda + c0 + tx + 16 * b] += part[a][b];
      __syncthreads();
    }
  }
}

// Shared memory of the KL column loop: the S staging, P
// (ps[r][c] = P[i + r][col0 + c]) and the W tile (ws[r][cc] = W[i + r][c0 + cc]).
template <int TN>
struct KlColStage {
  WhStage<4, TN> wh;
  float ps[kTile * (16 * TN + 1)];
  float ws[kTile * (kTile + 1)];
};

// The KL H-side loop over the rows [i0, i1) of X for the columns
// [col0, col0 + 16 TN): acc[c][j] += sum_i W[i][c] P[i][col0 + j], with
// P = X / (W H + eps) and acc row-major of stride 16 TN + 1 (kpad rows).
template <typename XT, int TN>
__device__ __forceinline__ void kl_cols(const XT* __restrict__ x, const float* __restrict__ w,
                                        const float* __restrict__ h, int m, int n, int k,
                                        int kpad, int col0, int i0, int i1, float* acc,
                                        KlColStage<TN>& st) {
  constexpr int TM = 4, BM = kTile, BN = 16 * TN, LDP = BN + 1, LDW = BM + 1, ldc = BN + 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int it = i0; it < i1; it += BM) {
    float s[TM][TN];
    wh_tile<TM, TN>(s, w, h, m, n, k, it, col0, st.wh);  // ends with a barrier
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b, gi = it + r, gc = col0 + c;
        st.ps[r * LDP + c] =
            (gi < m && gc < n) ? to_f32(x[(long long)gi * n + gc]) / (s[a][b] + kEps) : 0.f;
      }
    }
    for (int c0 = 0; c0 < kpad; c0 += BM) {
      for (int l = tid; l < BM * BM; l += kThreads) {
        const int r = l / BM, cc = l % BM, gi = it + r, gk = c0 + cc;
        st.ws[r * LDW + cc] = (gi < m && gk < k) ? w[(long long)gi * k + gk] : 0.f;
      }
      __syncthreads();
      float part[TM][TN];
      zero(part);
      micro_gemm<TM, TN>(part, st.ws, LDW, st.ps, LDP, BM, ty, tx);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[(c0 + ty + 16 * a) * ldc + tx + 16 * b] += part[a][b];
      __syncthreads();
    }
  }
}

// A block's double partial (one value per thread) reduced to thread 0's
// return value, in a fixed order.  Every thread of the block must call it.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double red[kThreads];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  return red[0];
}

}  // namespace tpunmf
