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
// version is plain shared-memory tiling with f32 FMA; its tile loops live in
// common.cuh, shared with the single-pass iteration (mur_iteration.cu).
// Tensor cores (mma/wgmma), TMA and warp specialisation are later work.
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

// ----------------------------------------------------------------- EU, W pass
// out = W * (X H^T) / (W Gh + lam W + eps); grid (ceil(m/64), ceil(k/64)).
template <typename XT>
__global__ void __launch_bounds__(kThreads)
    w_eu_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ h, const float* __restrict__ gh, float lam,
                int m, int n, int k, float* __restrict__ out) {
  __shared__ EuStage st;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;

  float numer[4][4], den[4][4];
  zero(numer);
  x_ft_tile<XT>(numer, x, h, m, n, k, row0, c0, 0, n, st);
  zero(den);
  w_g_tile(den, w, gh, m, k, row0, c0, st);

#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
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
  constexpr int LD = kTile + 1;
  __shared__ EuStage st;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;

  float numer[4][4];
  zero(numer);
  ft_x_tile<XT>(numer, x, w, n, k, col0, c0, 0, m, st);

  float den[4][4];
  zero(den);
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int r = l / kChunk, kk = l % kChunk, gr = c0 + r, gk = k0 + kk;
      st.a[kk * LD + r] = (gr < k && gk < k) ? gw[(long long)gr * k + gk] : 0.f;
    }
    for (int l = tid; l < kChunk * kTile; l += kThreads) {
      const int kk = l / kTile, c = l % kTile, gk = k0 + kk, gj = col0 + c;
      st.b[kk * LD + c] = (gk < k && gj < n) ? h[(long long)gk * n + gj] : 0.f;
    }
    __syncthreads();
    micro_gemm<4, 4>(den, st.a, LD, st.b, LD, kChunk, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
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
  constexpr int BM = 16 * TM;
  __shared__ KlRowStage<TM> st;
  extern __shared__ float acc[];  // acc[r][c], row stride kpad + 1
  const int lda = kpad + 1;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;

  double obj = 0.0;  // this thread's cells
  for (int l = tid; l < BM * lda; l += kThreads) acc[l] = 0.f;
  kl_rows<XT, TM, LAGGED>(x, w, h, m, n, k, kpad, row0, 0, n, acc, lda, obj, st);

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
    const double sum = block_sum(obj);
    if (tid == 0) partials[blockIdx.x] = (float)sum;
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
  constexpr int BN = 16 * TN, ldc = BN + 1;
  __shared__ KlColStage<TN> st;
  extern __shared__ float acc[];  // acc[ck][c], row stride BN + 1
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * BN;

  for (int l = tid; l < kpad * ldc; l += kThreads) acc[l] = 0.f;
  kl_cols<XT, TN>(x, w, h, m, n, k, kpad, col0, 0, m, acc, st);

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

template <typename XT, bool LAGGED>
cudaError_t w_kl_update(const XT* x, const float* w, const float* h, const float* hsum,
                        float lam, int m, int n, int k, float* out, float* partials,
                        cudaStream_t s) {
  const int kpad = ceil_div(k, kTile) * kTile, bm = kl_block(k);
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
  return reduce_partials_into(partials, ceil_div(m, kl_block(k)), 1.f, obj, s);
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
  return tpunmf::ceil_div(m, tpunmf::kl_block(k));
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
