// Masked (weighted) MUR: the W half-update and the H half-update, each one
// pass over (X, M) with the update fused into its epilogue.
//
// Replaces the Pallas kernels of tpunmf/ops/masked_fused.py:
//   masked_w_update (:129, pallas_call :152): _w_eu_masked_kernel (:77),
//                                             _w_kl_masked_kernel (:101)
//   masked_h_update (:224, pallas_call :246): _h_eu_masked_kernel (:173),
//                                             _h_kl_masked_kernel (:197)
//
//   EU: W <- W * ((M*X) H^T) / ((M*(W H)) H^T + lam W + eps)
//   KL: a = W * ((M*X / (W H + eps)) H^T), b = M H^T,
//       den = b + sqrt(b^2 + 4 lam a); W <- den > 0 ? 2a / den : W
//   (and the mirror for H with W^T on the left).  The KL guard keeps the
//   entries of a fully unobserved row (column); EU has none, as on the TPU.
//
// Bound on the H100: 6*m*n*k f32 FMA flops per pass (S = W_i H_j and two
// products against the same factor tile) on one read of X and M, so, as the
// unmasked KL kernels, FMA throughput bounds them, not HBM.  Design: the
// structure of mur_update.cu's w_kl_kernel / h_kl_kernel.  A block owns
// whole rows of W (columns of H), forms S in registers per 64-wide tile,
// writes the two masked operands (EU: M*X and M*S; KL: M*X/(S+eps) and M) to
// shared memory, and adds both products into two rows x k accumulators in
// dynamic shared memory.  Two accumulators double the KL kernels' budget, so
// the block is halved above k = 256 and again above k = 512: at most about
// 190 KB of the 227 KB.  All shared memory is dynamic (the staging alone is
// above the 48 KB static limit).
//
// X is f32 or bf16 and M is 1-byte (binary) or X's type (weights); both are
// upcast to f32 and the factors are not rounded to X's type
// (masked_fused.py:86-92, 182-188).  Ragged edges load zeros and bound their
// stores.  Built without --use_fast_math.
#include "common.cuh"

namespace tpunmf {
namespace {

constexpr int kTile = 64;

// Dynamic shared memory of a masked block: two accumulators of `acc` floats
// each, two masked operand tiles of `p` floats, one factor tile of `t`
// floats, and the S staging.
template <int TM, int TN>
size_t masked_smem(int acc, int p, int t) {
  return (2 * (size_t)acc + 2 * (size_t)p + (size_t)t) * sizeof(float) +
         sizeof(WhStage<TM, TN>);
}

// ------------------------------------------------------------------ W pass
// A block owns rows [row0, row0 + 16*TM) and all k; grid ceil(m / (16*TM)).
template <typename XT, typename MT, int TM>
__global__ void __launch_bounds__(kThreads)
    masked_w_kernel(const XT* __restrict__ x, const MT* __restrict__ mask,
                    const float* __restrict__ w, const float* __restrict__ h, float lam,
                    int m, int n, int k, int kpad, bool kl, float* __restrict__ out) {
  constexpr int TN = 4, BM = 16 * TM, BN = kTile, LDP = BM + 1, LDT = BN + 1;
  extern __shared__ float smem[];
  const int lda = kpad + 1;
  float* acc_n = smem;              // numerator     acc[r][c], row stride kpad + 1
  float* acc_d = acc_n + BM * lda;  // denominator (EU) or M H^T (KL)
  float* pn = acc_d + BM * lda;     // transposed: pn[t][r] = P[row0 + r][j0 + t]
  float* pd = pn + BN * LDP;
  float* ts = pd + BN * LDP;        // ts[t][c] = H[c0 + c][j0 + t]
  WhStage<TM, TN>& stage = *reinterpret_cast<WhStage<TM, TN>*>(ts + BN * LDT);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM;

  for (int l = tid; l < 2 * BM * lda; l += kThreads) smem[l] = 0.f;
  for (int j0 = 0; j0 < n; j0 += BN) {
    float s[TM][TN];
    wh_tile<TM, TN>(s, w, h, m, n, k, row0, j0, stage);  // ends with a barrier
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b, gr = row0 + r, gc = j0 + c;
        float vn = 0.f, vd = 0.f;
        if (gr < m && gc < n) {
          const long long o = (long long)gr * n + gc;
          const float mv = to_f32(mask[o]), xv = to_f32(x[o]);
          vn = kl ? mv * xv / (s[a][b] + kEps) : xv * mv;
          vd = kl ? mv : mv * s[a][b];
        }
        pn[c * LDP + r] = vn;
        pd[c * LDP + r] = vd;
      }
    }
    for (int c0 = 0; c0 < kpad; c0 += BN) {
      for (int l = tid; l < BN * BN; l += kThreads) {
        const int cc = l / BN, t = l % BN, gk = c0 + cc, gc = j0 + t;
        ts[t * LDT + cc] = (gk < k && gc < n) ? h[(long long)gk * n + gc] : 0.f;
      }
      __syncthreads();
      float part_n[TM][TN], part_d[TM][TN];
      zero(part_n);
      zero(part_d);
      micro_gemm<TM, TN>(part_n, pn, LDP, ts, LDT, BN, ty, tx);
      micro_gemm<TM, TN>(part_d, pd, LDP, ts, LDT, BN, ty, tx);
#pragma unroll
      for (int a = 0; a < TM; ++a) {
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          const int o = (ty + 16 * a) * lda + c0 + tx + 16 * b;
          acc_n[o] += part_n[a][b];
          acc_d[o] += part_d[a][b];
        }
      }
      __syncthreads();
    }
  }

  for (int l = tid; l < BM * k; l += kThreads) {
    const int r = l / k, c = l % k, gr = row0 + r;
    if (gr < m) {
      const long long o = (long long)gr * k + c;
      const float wv = w[o], nu = acc_n[r * lda + c], de = acc_d[r * lda + c];
      if (kl) {
        const float a = wv * nu;
        const float den = de + sqrtf(de * de + 4.f * lam * a);
        out[o] = den > 0.f ? 2.f * a / den : wv;
      } else {
        out[o] = wv * nu / (de + lam * wv + kEps);
      }
    }
  }
}

// ------------------------------------------------------------------ H pass
// A block owns columns [col0, col0 + 16*TN) and all k; grid ceil(n / (16*TN)).
template <typename XT, typename MT, int TN>
__global__ void __launch_bounds__(kThreads)
    masked_h_kernel(const XT* __restrict__ x, const MT* __restrict__ mask,
                    const float* __restrict__ w, const float* __restrict__ h, float lam,
                    int m, int n, int k, int kpad, bool kl, float* __restrict__ out) {
  constexpr int TM = 4, BM = kTile, BN = 16 * TN, LDP = BN + 1, LDW = BM + 1, LDC = BN + 1;
  extern __shared__ float smem[];
  float* acc_n = smem;               // numerator      acc[ck][c], row stride BN + 1
  float* acc_d = acc_n + kpad * LDC; // denominator (EU) or W^T M (KL)
  float* pn = acc_d + kpad * LDC;    // pn[r][c] = P[i0 + r][col0 + c]
  float* pd = pn + BM * LDP;
  float* ws = pd + BM * LDP;         // ws[r][cc] = W[i0 + r][c0 + cc]
  WhStage<TM, TN>& stage = *reinterpret_cast<WhStage<TM, TN>*>(ws + BM * LDW);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * BN;

  for (int l = tid; l < 2 * kpad * LDC; l += kThreads) smem[l] = 0.f;
  for (int i0 = 0; i0 < m; i0 += BM) {
    float s[TM][TN];
    wh_tile<TM, TN>(s, w, h, m, n, k, i0, col0, stage);  // ends with a barrier
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b, gi = i0 + r, gc = col0 + c;
        float vn = 0.f, vd = 0.f;
        if (gi < m && gc < n) {
          const long long o = (long long)gi * n + gc;
          const float mv = to_f32(mask[o]), xv = to_f32(x[o]);
          vn = kl ? mv * xv / (s[a][b] + kEps) : xv * mv;
          vd = kl ? mv : mv * s[a][b];
        }
        pn[r * LDP + c] = vn;
        pd[r * LDP + c] = vd;
      }
    }
    for (int c0 = 0; c0 < kpad; c0 += BM) {
      for (int l = tid; l < BM * BM; l += kThreads) {
        const int r = l / BM, cc = l % BM, gi = i0 + r, gk = c0 + cc;
        ws[r * LDW + cc] = (gi < m && gk < k) ? w[(long long)gi * k + gk] : 0.f;
      }
      __syncthreads();
      float part_n[TM][TN], part_d[TM][TN];
      zero(part_n);
      zero(part_d);
      micro_gemm<TM, TN>(part_n, ws, LDW, pn, LDP, BM, ty, tx);
      micro_gemm<TM, TN>(part_d, ws, LDW, pd, LDP, BM, ty, tx);
#pragma unroll
      for (int a = 0; a < TM; ++a) {
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          const int o = (c0 + ty + 16 * a) * LDC + tx + 16 * b;
          acc_n[o] += part_n[a][b];
          acc_d[o] += part_d[a][b];
        }
      }
      __syncthreads();
    }
  }

  for (int l = tid; l < k * BN; l += kThreads) {
    const int ck = l / BN, c = l % BN, gc = col0 + c;
    if (gc < n) {
      const long long o = (long long)ck * n + gc;
      const float hv = h[o], nu = acc_n[ck * LDC + c], de = acc_d[ck * LDC + c];
      if (kl) {
        const float cv = hv * nu;
        const float den = de + sqrtf(de * de + 4.f * lam * cv);
        out[o] = den > 0.f ? 2.f * cv / den : hv;
      } else {
        out[o] = hv * nu / (de + lam * hv + kEps);
      }
    }
  }
}

// k above these halves the block along the axis that holds all of k.
constexpr int kHalfRank = 256, kQuarterRank = 512;

template <typename XT, typename MT>
cudaError_t w_update(const void* xv, const void* mv, const float* w, const float* h,
                     float lam, int m, int n, int k, bool kl, float* out, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  const MT* mk = static_cast<const MT*>(mv);
  const int kpad = ceil_div(k, kTile) * kTile;
  if (k <= kHalfRank) {
    constexpr int BM = 64;
    return launch(masked_w_kernel<XT, MT, 4>, dim3(ceil_div(m, BM)),
                  masked_smem<4, 4>(BM * (kpad + 1), kTile * (BM + 1), kTile * (kTile + 1)),
                  s, x, mk, w, h, lam, m, n, k, kpad, kl, out);
  }
  if (k <= kQuarterRank) {
    constexpr int BM = 32;
    return launch(masked_w_kernel<XT, MT, 2>, dim3(ceil_div(m, BM)),
                  masked_smem<2, 4>(BM * (kpad + 1), kTile * (BM + 1), kTile * (kTile + 1)),
                  s, x, mk, w, h, lam, m, n, k, kpad, kl, out);
  }
  constexpr int BM = 16;
  return launch(masked_w_kernel<XT, MT, 1>, dim3(ceil_div(m, BM)),
                masked_smem<1, 4>(BM * (kpad + 1), kTile * (BM + 1), kTile * (kTile + 1)), s,
                x, mk, w, h, lam, m, n, k, kpad, kl, out);
}

template <typename XT, typename MT>
cudaError_t h_update(const void* xv, const void* mv, const float* w, const float* h,
                     float lam, int m, int n, int k, bool kl, float* out, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  const MT* mk = static_cast<const MT*>(mv);
  const int kpad = ceil_div(k, kTile) * kTile;
  if (k <= kHalfRank) {
    constexpr int BN = 64;
    return launch(masked_h_kernel<XT, MT, 4>, dim3(ceil_div(n, BN)),
                  masked_smem<4, 4>(kpad * (BN + 1), kTile * (BN + 1), kTile * (kTile + 1)),
                  s, x, mk, w, h, lam, m, n, k, kpad, kl, out);
  }
  if (k <= kQuarterRank) {
    constexpr int BN = 32;
    return launch(masked_h_kernel<XT, MT, 2>, dim3(ceil_div(n, BN)),
                  masked_smem<4, 2>(kpad * (BN + 1), kTile * (BN + 1), kTile * (kTile + 1)),
                  s, x, mk, w, h, lam, m, n, k, kpad, kl, out);
  }
  constexpr int BN = 16;
  return launch(masked_h_kernel<XT, MT, 1>, dim3(ceil_div(n, BN)),
                masked_smem<4, 1>(kpad * (BN + 1), kTile * (BN + 1), kTile * (kTile + 1)), s,
                x, mk, w, h, lam, m, n, k, kpad, kl, out);
}

// One half-update for the (X type, mask type) pair of a call: mask_is_byte
// selects 1-byte masks, else the mask has X's type.
cudaError_t masked_update(bool h_pass, int x_is_bf16, int mask_is_byte, const void* x,
                          const void* mask, const float* w, const float* h, float lam,
                          int m, int n, int k, bool kl, float* out, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using byte = unsigned char;
  if (x_is_bf16) {
    if (mask_is_byte)
      return h_pass ? h_update<bf16, byte>(x, mask, w, h, lam, m, n, k, kl, out, s)
                    : w_update<bf16, byte>(x, mask, w, h, lam, m, n, k, kl, out, s);
    return h_pass ? h_update<bf16, bf16>(x, mask, w, h, lam, m, n, k, kl, out, s)
                  : w_update<bf16, bf16>(x, mask, w, h, lam, m, n, k, kl, out, s);
  }
  if (mask_is_byte)
    return h_pass ? h_update<float, byte>(x, mask, w, h, lam, m, n, k, kl, out, s)
                  : w_update<float, byte>(x, mask, w, h, lam, m, n, k, kl, out, s);
  return h_pass ? h_update<float, float>(x, mask, w, h, lam, m, n, k, kl, out, s)
                : w_update<float, float>(x, mask, w, h, lam, m, n, k, kl, out, s);
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// Masked W half-update: out (m, k).  x (m, n) is f32 or bf16 (x_is_bf16);
// mask (m, n) is 1-byte 0/1 (mask_is_byte) or of x's type.
int tpunmf_masked_w_update(const void* x, int x_is_bf16, const void* mask, int mask_is_byte,
                           const void* w, const void* h, float lam, int m, int n, int k,
                           int is_kl, void* out, void* stream) {
  return static_cast<int>(tpunmf::masked_update(
      false, x_is_bf16, mask_is_byte, x, mask, static_cast<const float*>(w),
      static_cast<const float*>(h), lam, m, n, k, is_kl != 0, static_cast<float*>(out),
      static_cast<cudaStream_t>(stream)));
}

// Masked H half-update: out (k, n), with the already-updated W.
int tpunmf_masked_h_update(const void* x, int x_is_bf16, const void* mask, int mask_is_byte,
                           const void* w, const void* h, float lam, int m, int n, int k,
                           int is_kl, void* out, void* stream) {
  return static_cast<int>(tpunmf::masked_update(
      true, x_is_bf16, mask_is_byte, x, mask, static_cast<const float*>(w),
      static_cast<const float*>(h), lam, m, n, k, is_kl != 0, static_cast<float*>(out),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
