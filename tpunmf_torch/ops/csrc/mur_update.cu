// The 2-pass fused MUR iteration: the W half-update and the H half-update,
// each one pass over X with the update fused into its epilogue.
//
// Replaces the Pallas kernels of tpunmf/ops/mur_fused.py:
//   mur_w_update (:169, pallas_call :245): _w_eu_kernel (:76), _w_kl_kernel (:95)
//   mur_w_update(with_lagged_obj=True) (pallas_call :227): _w_kl_obj_kernel (:114)
//   mur_h_update (:750, pallas_call :797): _h_eu_kernel (:708), _h_kl_kernel (:729)
//
// Bound on the H100: every kernel reads X once (4 or 2 bytes a cell) and does
// 2*m*n*k (EU) or 4*m*n*k (KL) f32 FMA flops on it, k/2 to k flops per X byte:
// above the f32 FMA ridge (~20 flop/byte) at the slice's ranks 50-128, so the
// FMA throughput of the tiles bounds these kernels, not HBM.  This first
// version is plain shared-memory tiling with f32 FMA (common.cuh); tensor
// cores (mma/wgmma), TMA and warp specialisation are left for later work.
//
// Design:
//  * EU (w_eu_kernel, h_eu_kernel): a block owns a 64 x 64 tile of the output
//    (rows of W by a slice of k, or a slice of k by columns of H) and loops over
//    the contraction axis of X; a second short loop forms W*Gh (or Gw*H) for
//    the epilogue.  The factor is rounded to X's dtype before the product, as
//    on the TPU (mur_fused.py:84, :716).
//  * KL (w_kl_kernel, h_kl_kernel): the ratio X / (W H + eps) needs S = W_i H_j
//    over the full rank, so a block owns whole rows of W (or whole columns of
//    H) and loops over the other axis of X: per step it forms S in registers,
//    writes P = X/(S+eps) to shared memory, and adds P H_j^T (or W_i^T P) into
//    a (rows x k) accumulator held in dynamic shared memory (at most 135 KB at
//    k = 1024; the block is halved in that direction above k = 512).  X is
//    upcast to f32, as on the TPU (mur_fused.py:103, :737).
//  * The lagged W pass (w_kl_kernel<..., LAGGED = true>) also sums the masked
//    KL of the incoming (W, H) from the same S tiles, with the raw S (no eps)
//    in the log, as mur_fused.py:134-138.  The TPU added into one SMEM scalar
//    over its sequential grid; here each block writes one partial and
//    reduce_partials_into (objective.cu) adds them in a fixed order, so the sum is
//    bit-reproducible run to run.  No float atomics.
//  * Ragged edges are masked by zero loads and bounds-checked stores, so any
//    (m, n, k <= 1024) works; the TPU needed dividing blocks.
//  * Nothing is written in place: the wrapper allocates fresh outputs.
// Built without --use_fast_math: division and sqrtf stay IEEE.
#include "common.cuh"

namespace tpunmf {
namespace {

constexpr int kTile = 64;  // 16 * 4: the EU kernels' tile, and the KL kernels'
                           // tile along the axis of X they loop over

// ----------------------------------------------------------------- EU, W pass
// out = W * (X H^T) / (W Gh + lam W + eps); grid (ceil(m/64), ceil(k/64)).
template <typename XT>
__global__ void __launch_bounds__(kThreads)
    w_eu_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ h, const float* __restrict__ gh, float lam,
                int m, int n, int k, float* __restrict__ out) {
  constexpr int TM = 4, TN = 4, LD = kTile + 1;
  __shared__ float As[kChunk * LD];
  __shared__ float Bs[kChunk * LD];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;

  float numer[TM][TN];
  zero(numer);
  for (int j0 = 0; j0 < n; j0 += kChunk) {
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int r = l / kChunk, kk = l % kChunk, gr = row0 + r, gj = j0 + kk;
      As[kk * LD + r] = (gr < m && gj < n) ? to_f32(x[(long long)gr * n + gj]) : 0.f;
    }
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int c = l / kChunk, kk = l % kChunk, gc = c0 + c, gj = j0 + kk;
      Bs[kk * LD + c] = (gc < k && gj < n) ? round_as_x<XT>(h[(long long)gc * n + gj]) : 0.f;
    }
    __syncthreads();
    micro_gemm<TM, TN>(numer, As, LD, Bs, LD, kChunk, ty, tx);
    __syncthreads();
  }

  float den[TM][TN];
  zero(den);
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int r = l / kChunk, kk = l % kChunk, gr = row0 + r, gk = k0 + kk;
      As[kk * LD + r] = (gr < m && gk < k) ? w[(long long)gr * k + gk] : 0.f;
    }
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int kk = l / kTile, c = l % kTile, gk = k0 + kk, gc = c0 + c;
      Bs[kk * LD + c] = (gk < k && gc < k) ? gh[(long long)gk * k + gc] : 0.f;
    }
    __syncthreads();
    micro_gemm<TM, TN>(den, As, LD, Bs, LD, kChunk, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int gr = row0 + ty + 16 * a, gc = c0 + tx + 16 * b;
      if (gr < m && gc < k) {
        const float wv = w[(long long)gr * k + gc];
        out[(long long)gr * k + gc] = wv * numer[a][b] / (den[a][b] + lam * wv + kEps);
      }
    }
  }
}

// ----------------------------------------------------------------- EU, H pass
// numer = W^T X; h_out = H * numer / (Gw H + lam H + eps);
// grid (ceil(n/64), ceil(k/64)).
template <typename XT>
__global__ void __launch_bounds__(kThreads)
    h_eu_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ h, const float* __restrict__ gw, float lam,
                int m, int n, int k, float* __restrict__ h_out,
                float* __restrict__ numer_out) {
  constexpr int TM = 4, TN = 4, LD = kTile + 1;
  __shared__ float As[kChunk * LD];
  __shared__ float Bs[kChunk * LD];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;

  float numer[TM][TN];
  zero(numer);
  for (int i0 = 0; i0 < m; i0 += kChunk) {
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int kk = l / kTile, r = l % kTile, gi = i0 + kk, gc = c0 + r;
      As[kk * LD + r] = (gi < m && gc < k) ? round_as_x<XT>(w[(long long)gi * k + gc]) : 0.f;
    }
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int kk = l / kTile, c = l % kTile, gi = i0 + kk, gj = col0 + c;
      Bs[kk * LD + c] = (gi < m && gj < n) ? to_f32(x[(long long)gi * n + gj]) : 0.f;
    }
    __syncthreads();
    micro_gemm<TM, TN>(numer, As, LD, Bs, LD, kChunk, ty, tx);
    __syncthreads();
  }

  float den[TM][TN];
  zero(den);
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int r = l / kChunk, kk = l % kChunk, gr = c0 + r, gk = k0 + kk;
      As[kk * LD + r] = (gr < k && gk < k) ? gw[(long long)gr * k + gk] : 0.f;
    }
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int kk = l / kTile, c = l % kTile, gk = k0 + kk, gj = col0 + c;
      Bs[kk * LD + c] = (gk < k && gj < n) ? h[(long long)gk * n + gj] : 0.f;
    }
    __syncthreads();
    micro_gemm<TM, TN>(den, As, LD, Bs, LD, kChunk, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int gr = c0 + ty + 16 * a, gj = col0 + tx + 16 * b;
      if (gr < k && gj < n) {
        const long long o = (long long)gr * n + gj;
        const float hv = h[o];
        numer_out[o] = numer[a][b];
        h_out[o] = hv * numer[a][b] / (den[a][b] + lam * hv + kEps);
      }
    }
  }
}

// ----------------------------------------------------------------- KL, W pass
// a = W * ((X / (W H + eps)) H^T), b = hsum; out = 2a / (b + sqrt(b^2 + 4 lam a)).
// A block owns rows [row0, row0 + 16*TM) and all k; grid ceil(m / (16*TM)).
// Dynamic shared memory: the (16*TM) x (kpad + 1) accumulator.
// LAGGED: partials[blockIdx.x] = the block's rows' masked KL(X, W H) of the
// incoming W, H (tpunmf/core/losses.py:20-25 masking, as objective.cu).
template <typename XT, int TM, bool LAGGED>
__global__ void __launch_bounds__(kThreads)
    w_kl_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ h, const float* __restrict__ hsum, float lam,
                int m, int n, int k, int kpad, float* __restrict__ out,
                float* __restrict__ partials) {
  constexpr int TN = 4, BM = 16 * TM, BN = kTile, LDP = BM + 1, LDT = BN + 1;
  __shared__ WhStage<TM, TN> stage;
  __shared__ float Ps[BN * LDP];  // P transposed: Ps[t][r] = P[row0 + r][j0 + t]
  __shared__ float Ts[BN * LDT];  // Ts[t][c] = H[c0 + c][j0 + t]
  extern __shared__ float acc[];  // acc[r][c], row stride kpad + 1
  const int lda = kpad + 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM;

  double obj = 0.0;  // this thread's cells, one f32 sum per tile added in double
  for (int l = tid; l < BM * lda; l += kThreads) acc[l] = 0.f;
  for (int j0 = 0; j0 < n; j0 += BN) {
    float s[TM][TN];
    wh_tile<TM, TN>(s, w, h, m, n, k, row0, j0, stage);  // ends with a barrier
    float tile_obj = 0.f;
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b, gr = row0 + r, gc = j0 + c;
        const bool in = gr < m && gc < n;
        const float xv = in ? to_f32(x[(long long)gr * n + gc]) : 0.f;
        Ps[c * LDP + r] = in ? xv / (s[a][b] + kEps) : 0.f;
        if (LAGGED && in) tile_obj += kl_term(xv, s[a][b]);
      }
    }
    if (LAGGED) obj += tile_obj;
    for (int c0 = 0; c0 < kpad; c0 += BN) {
      for (int l = tid; l < BN * BN; l += kThreads) {
        const int cc = l / BN, t = l % BN, gk = c0 + cc, gc = j0 + t;
        Ts[t * LDT + cc] = (gk < k && gc < n) ? h[(long long)gk * n + gc] : 0.f;
      }
      __syncthreads();
      float part[TM][TN];
      zero(part);
      micro_gemm<TM, TN>(part, Ps, LDP, Ts, LDT, BN, ty, tx);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[(ty + 16 * a) * lda + c0 + tx + 16 * b] += part[a][b];
      __syncthreads();
    }
  }

  for (int l = tid; l < BM * k; l += kThreads) {
    const int r = l / k, c = l % k, gr = row0 + r;
    if (gr < m) {
      const long long o = (long long)gr * k + c;
      const float a = w[o] * acc[r * lda + c];
      const float b = hsum[c];
      out[o] = 2.f * a / (b + sqrtf(b * b + 4.f * lam * a));
    }
  }
  if constexpr (LAGGED) {
    __shared__ double red[kThreads];
    red[tid] = obj;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride /= 2) {
      if (tid < stride) red[tid] += red[tid + stride];
      __syncthreads();
    }
    if (tid == 0) partials[blockIdx.x] = (float)red[0];
  }
}

// ----------------------------------------------------------------- KL, H pass
// numer = W^T (X / (W H + eps)), c = H * numer, d = wsum;
// h_out = 2c / (d + sqrt(d^2 + 4 lam c)).
// A block owns columns [col0, col0 + 16*TN) and all k; grid ceil(n / (16*TN)).
// Dynamic shared memory: the kpad x (16*TN + 1) accumulator.
template <typename XT, int TN>
__global__ void __launch_bounds__(kThreads)
    h_kl_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ h, const float* __restrict__ wsum, float lam,
                int m, int n, int k, int kpad, float* __restrict__ h_out,
                float* __restrict__ numer_out) {
  constexpr int TM = 4, BM = kTile, BN = 16 * TN, LDP = BN + 1, LDW = BM + 1;
  __shared__ WhStage<TM, TN> stage;
  __shared__ float Ps[BM * LDP];  // Ps[r][c] = P[i0 + r][col0 + c]
  __shared__ float Ws[BM * LDW];  // Ws[r][cc] = W[i0 + r][c0 + cc]
  extern __shared__ float acc[];  // acc[ck][c], row stride BN + 1
  constexpr int ldc = BN + 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * BN;

  for (int l = tid; l < kpad * ldc; l += kThreads) acc[l] = 0.f;
  for (int i0 = 0; i0 < m; i0 += BM) {
    float s[TM][TN];
    wh_tile<TM, TN>(s, w, h, m, n, k, i0, col0, stage);  // ends with a barrier
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b, gi = i0 + r, gc = col0 + c;
        Ps[r * LDP + c] =
            (gi < m && gc < n) ? to_f32(x[(long long)gi * n + gc]) / (s[a][b] + kEps) : 0.f;
      }
    }
    for (int c0 = 0; c0 < kpad; c0 += BM) {
      for (int l = tid; l < BM * BM; l += kThreads) {
        const int r = l / BM, cc = l % BM, gi = i0 + r, gk = c0 + cc;
        Ws[r * LDW + cc] = (gi < m && gk < k) ? w[(long long)gi * k + gk] : 0.f;
      }
      __syncthreads();
      float part[TM][TN];
      zero(part);
      micro_gemm<TM, TN>(part, Ws, LDW, Ps, LDP, BM, ty, tx);
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[(c0 + ty + 16 * a) * ldc + tx + 16 * b] += part[a][b];
      __syncthreads();
    }
  }

  for (int l = tid; l < k * BN; l += kThreads) {
    const int ck = l / BN, c = l % BN, gc = col0 + c;
    if (gc < n) {
      const long long o = (long long)ck * n + gc;
      const float nu = acc[ck * ldc + c];
      numer_out[o] = nu;
      const float cv = h[o] * nu;
      const float d = wsum[ck];
      h_out[o] = 2.f * cv / (d + sqrtf(d * d + 4.f * lam * cv));
    }
  }
}

// k above this halves the KL block along the axis that holds all of k, so the
// accumulator stays near 130 KB of shared memory.
constexpr int kWideRank = 512;

// Rows of W a KL W-pass block owns at rank k.
int w_kl_rows(int k) { return k <= kWideRank ? 64 : 32; }

template <typename XT, bool LAGGED>
cudaError_t w_kl_update(const XT* x, const float* w, const float* h, const float* hsum,
                        float lam, int m, int n, int k, float* out, float* partials,
                        cudaStream_t s) {
  const int kpad = ceil_div(k, kTile) * kTile, bm = w_kl_rows(k);
  const size_t smem = bm * (kpad + 1) * sizeof(float);
  return bm == 64 ? launch(w_kl_kernel<XT, 4, LAGGED>, dim3(ceil_div(m, bm)), smem, s, x, w,
                           h, hsum, lam, m, n, k, kpad, out, partials)
                  : launch(w_kl_kernel<XT, 2, LAGGED>, dim3(ceil_div(m, bm)), smem, s, x, w,
                           h, hsum, lam, m, n, k, kpad, out, partials);
}

template <typename XT>
cudaError_t w_update(const void* xv, const float* w, const float* h, const float* aux,
                     float lam, int m, int n, int k, bool kl, float* out, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  if (!kl) {
    return launch(w_eu_kernel<XT>, dim3(ceil_div(m, kTile), ceil_div(k, kTile)), 0, s, x,
                  w, h, aux, lam, m, n, k, out);
  }
  return w_kl_update<XT, false>(x, w, h, aux, lam, m, n, k, out, nullptr, s);
}

template <typename XT>
cudaError_t w_update_lagged(const void* xv, const float* w, const float* h,
                            const float* hsum, float lam, int m, int n, int k, float* out,
                            float* partials, float* obj, cudaStream_t s) {
  cudaError_t err = w_kl_update<XT, true>(static_cast<const XT*>(xv), w, h, hsum, lam, m, n,
                                          k, out, partials, s);
  if (err != cudaSuccess) return err;
  return reduce_partials_into(partials, ceil_div(m, w_kl_rows(k)), 1.f, obj, s);
}

template <typename XT>
cudaError_t h_update(const void* xv, const float* w, const float* h, const float* aux,
                     float lam, int m, int n, int k, bool kl, float* h_out, float* numer,
                     cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  if (!kl) {
    return launch(h_eu_kernel<XT>, dim3(ceil_div(n, kTile), ceil_div(k, kTile)), 0, s, x, w,
                  h, aux, lam, m, n, k, h_out, numer);
  }
  const int kpad = ceil_div(k, kTile) * kTile;
  if (k <= kWideRank) {
    constexpr int BN = 64;
    return launch(h_kl_kernel<XT, 4>, dim3(ceil_div(n, BN)), kpad * (BN + 1) * sizeof(float),
                  s, x, w, h, aux, lam, m, n, k, kpad, h_out, numer);
  }
  constexpr int BN = 32;
  return launch(h_kl_kernel<XT, 2>, dim3(ceil_div(n, BN)), kpad * (BN + 1) * sizeof(float), s,
                x, w, h, aux, lam, m, n, k, kpad, h_out, numer);
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// W half-update.  aux is Gh = H H^T (k, k) for EU, rowsum(H) (k,) for KL.
int tpunmf_mur_w_update(const void* x, int x_is_bf16, const void* w, const void* h,
                        const void* aux, float lam, int m, int n, int k, int is_kl,
                        void* out, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  const float* af = static_cast<const float*>(aux);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_is_bf16
          ? tpunmf::w_update<__nv_bfloat16>(x, wf, hf, af, lam, m, n, k, is_kl, o, s)
          : tpunmf::w_update<float>(x, wf, hf, af, lam, m, n, k, is_kl, o, s);
  return static_cast<int>(err);
}

// Rows of partials tpunmf_mur_w_update_lagged needs at (m, k).
int tpunmf_mur_w_lagged_blocks(int m, int k) {
  return tpunmf::ceil_div(m, tpunmf::w_kl_rows(k));
}

// KL W half-update that also writes the masked KL of the incoming (W, H) to
// obj[0] (the lagged objective).  hsum is rowsum(H) (k,); partials holds
// tpunmf_mur_w_lagged_blocks(m, k) floats of scratch.
int tpunmf_mur_w_update_lagged(const void* x, int x_is_bf16, const void* w, const void* h,
                               const void* hsum, float lam, int m, int n, int k, void* out,
                               void* partials, void* obj, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  const float* hs = static_cast<const float*>(hsum);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partials);
  float* ob = static_cast<float*>(obj);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_is_bf16
          ? tpunmf::w_update_lagged<__nv_bfloat16>(x, wf, hf, hs, lam, m, n, k, o, p, ob, s)
          : tpunmf::w_update_lagged<float>(x, wf, hf, hs, lam, m, n, k, o, p, ob, s);
  return static_cast<int>(err);
}

// H half-update.  aux is Gw = W^T W (k, k) for EU, colsum(W) (k,) for KL.
// Writes the updated H and the raw numerator, both (k, n).
int tpunmf_mur_h_update(const void* x, int x_is_bf16, const void* w, const void* h,
                        const void* aux, float lam, int m, int n, int k, int is_kl,
                        void* h_out, void* numer, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  const float* af = static_cast<const float*>(aux);
  float* ho = static_cast<float*>(h_out);
  float* nu = static_cast<float*>(numer);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_is_bf16
          ? tpunmf::h_update<__nv_bfloat16>(x, wf, hf, af, lam, m, n, k, is_kl, ho, nu, s)
          : tpunmf::h_update<float>(x, wf, hf, af, lam, m, n, k, is_kl, ho, nu, s);
  return static_cast<int>(err);
}

}  // extern "C"
