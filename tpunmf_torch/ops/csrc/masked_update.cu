// Masked (weighted) MUR: the W half-update and the H half-update, each one
// pass over (X, M) with the update fused into an epilogue.
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
// Work per pass: 6*m*n*k flops of products (S = W_i H_j and two products
// against the same factor tile) on one read of X and M.
//
// The W pass keeps f32 FMA tiles (the structure of mur_update.cu's
// w_kl_kernel): a block owns whole rows of W, forms S in registers per
// 64-wide tile, writes the two masked operands (EU: M*X and M*S; KL:
// M*X/(S+eps) and M) to shared memory, and adds both products into two
// rows x k accumulators in dynamic shared memory, the block halved above
// k = 256 and again above k = 512.
//
// The H pass runs on the tensor cores.  Its bound on the H100, with the
// products at 3xTF32 (165 TFLOP/s of f32 work, tf32x3.cuh): 6mnk = 2.865e11
// flops at MovieLens-10M's 69878 x 10677, k 64, take 1.736 ms, above the
// 1.121 ms of reading X (f32) and a uint8 M, so the products bound it.
// Design: kernel 1's grid is column tiles x row splits x 64-row chunks of
// k; a block owns 64 columns of H, one range of X's rows and 64 rows of k,
// and for each 64-row tile of its range forms S = W_i H_j with tf32x3.cuh's
// S tile (over all k; W and H by 16-byte cp.async in 32-deep chunks), while
// the W_i[:, chunk] tile comes into shared memory by 16-byte cp.async and X
// and M into registers, each thread loading the cells of its own S entries
// (a row of X starts on 16 bytes only where n % 4 == 0, and MovieLens-10M's
// n = 10677 is odd; loaded in S's layout they need no shared tile and no
// barrier), then writes P_n and P_d (the masked operands above) to shared
// memory, and adds
// W_i^T P_n and W_i^T P_d into two 64 x 64 accumulators held in registers,
// in 3xTF32 mma.sync, the two sums sharing each step's W_i fragments.  A
// zero numerator of KL's P_n (most cells: M is 98.7% zeros at
// MovieLens-10M) skips the division's slow path (div_zero_first, the same
// bits).  A rank above 64 takes more chunks, each forming S again.  Each block writes its two partial sums to a scratch buffer; kernel
// 2 adds the partials of each entry over the splits in a fixed order and
// applies the EU or KL epilogue: the same bits on every call, no float
// atomics.  The row splits (chosen by the wrapper, ops/masked_fused.py)
// give MovieLens-10M's 167 column tiles several blocks for each of the
// card's 132 SMs, where one block over all rows left the card idle.
//
// X is f32 or bf16 and M is 1-byte (binary) or X's type (weights); both are
// upcast to f32 and the factors are not rounded to X's type
// (masked_fused.py:86-92, 182-188).  Ragged edges load zeros and bound their
// stores.  Built without --use_fast_math.
#include "common.cuh"
#include "tf32x3.cuh"

namespace tpunmf {
namespace {

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
constexpr int kHTile = 64;    // rows of X a step, columns of H a block, rows of k a chunk
using HS = tc::STile<kHTile, kHTile, 2, 4>;  // warps 2 x 4, 32 x 16 each
constexpr int kLdp = kHTile + 8;             // P_n, P_d and the W_i chunk: row stride

// Dynamic shared memory of an H block: the S tile's staging, reused for
// P_n and P_d (pn[i][j] = P_n[i0 + i][col0 + j]); the W_i chunk
// (wc[i][c] = W[i0 + i][c0 + c]).
struct HSmem {
  union {
    HS::Stage stage;
    struct {
      alignas(16) float pn[kHTile * kLdp];
      alignas(16) float pd[kHTile * kLdp];
    } p;
  } u;
  alignas(16) float wc[kHTile * kLdp];
};

// Kernel 1: block (column tile, split, k chunk) writes its partial sums
// part[(split * 2 + q) * k * n + c * n + j], q = 0 numerator, 1 denominator
// (EU) or W^T M (KL), for its 64 columns j and 64 rows c of k.  Its rows of
// X are the tiles [split * tiles_per, (split + 1) * tiles_per) of 64.
// `w_aligned` / `h_aligned`: the rows of W / H start on 16 bytes.
template <typename XT, typename MT>
__global__ void __launch_bounds__(kThreads, 2)
    masked_h_tc_kernel(const XT* __restrict__ x, const MT* __restrict__ mask,
                       const float* __restrict__ w, const float* __restrict__ h, int m, int n,
                       int k, int tiles_per, bool kl, bool w_aligned, bool h_aligned,
                       float* __restrict__ part) {
  constexpr int MTL = HS::MT, NTL = HS::NT;
  extern __shared__ float4 smem_raw[];
  HSmem& sm = *reinterpret_cast<HSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kHTile, split = blockIdx.y, c0 = blockIdx.z * kHTile;
  const long long r_begin = (long long)split * tiles_per * kHTile;
  const long long r_end = min((long long)m, r_begin + (long long)tiles_per * kHTile);
  // the warp's piece of S, and of the sums: rows (of X, of k) [wr, wr + 32),
  // columns [wcol, wcol + 16)
  const int wr = HS::warp_row(warp), wcol = HS::warp_col(warp);
  const int g = lane >> 2, t = lane & 3;

  tc::Acc<MTL, NTL> acc_n, acc_d;
  tc::zero(acc_n);
  tc::zero(acc_d);
  for (long long i0 = r_begin; i0 < r_end; i0 += kHTile) {
    const int rows = (int)min((long long)kHTile, m - i0);
    // the W_i chunk: one cp.async group, complete by the S tile's first wait
    for (int l = tid; l < kHTile * kHTile / 4; l += kThreads) {
      const int r = l / (kHTile / 4), c = l % (kHTile / 4) * 4;
      stage_piece(sm.wc + r * kLdp + c, w + (i0 + r) * k + c0 + c, r < rows ? k - c0 - c : 0,
                  w_aligned);
    }
    cp_async_commit();
    // X and M at the cells of this thread's S entries, loaded before S is
    // formed and used after: in flight while the tensor cores work.  (A row
    // of X starts on 16 bytes only where n % 4 == 0; MovieLens-10M's
    // n = 10677 is odd, so the cells come one by one, zero outside X.)
    XT xr[MTL][NTL][4];
    MT mr[MTL][NTL][4];
#pragma unroll
    for (int i = 0; i < MTL; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = wr + 16 * i + g + (q >> 1) * 8, c = col0 + wcol + 8 * j + 2 * t + (q & 1);
          const bool in = r < rows && c < n;
          const long long o = (i0 + r) * n + c;
          xr[i][j][q] = in ? x[o] : zero_of<XT>();
          mr[i][j][q] = in ? mask[o] : zero_of<MT>();
        }

    tc::Acc<MTL, NTL> s;
    tc::s_tile<kHTile, kHTile, 2, 4>(s, w, h, m, n, k, (int)i0, col0, w_aligned, h_aligned,
                                     sm.u.stage);  // ends with a barrier
    // P_n, P_d (zero outside X, where X and M are 0)
#pragma unroll
    for (int i = 0; i < MTL; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pn[2], pd[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int q = 2 * half + v;
            const float xv = to_f32(xr[i][j][q]), mv = to_f32(mr[i][j][q]), sv = s[i][j][q];
            pn[v] = kl ? div_zero_first(mv * xv, sv + kEps) : xv * mv;
            pd[v] = kl ? mv : mv * sv;
          }
          const int o = (wr + 16 * i + g + 8 * half) * kLdp + wcol + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(sm.u.p.pn + o) = make_float2(pn[0], pn[1]);
          *reinterpret_cast<float2*>(sm.u.p.pd + o) = make_float2(pd[0], pd[1]);
        }
    __syncthreads();
    // acc += W_i[:, chunk]^T P over the tile's 64 rows (A read transposed,
    // once for both sums)
    tc::warp_mma2<MTL, NTL, true>(acc_n, acc_d, sm.wc, kLdp, sm.u.p.pn, sm.u.p.pd, kLdp, wr,
                                  wcol, kHTile, lane);
    __syncthreads();  // the tiles are read before the next step's copies land
  }

  const long long plane = (long long)k * n;
  float* out_n = part + 2 * split * plane;
  auto store = [&](float* out, const tc::Acc<MTL, NTL>& acc) {
    tc::for_pairs<MTL, NTL>(acc, wr, wcol, lane, [&](int r, int c, float v0, float v1) {
      const int gk = c0 + r, gc = col0 + c;
      if (gk >= k) return;
      if (gc < n) out[(long long)gk * n + gc] = v0;
      if (gc + 1 < n) out[(long long)gk * n + gc + 1] = v1;
    });
  };
  store(out_n, acc_n);
  store(out_n + plane, acc_d);
}

// Kernel 2: nu, de = the sums of the partials over the splits, in split
// order; then the epilogue into out (k, n).
__global__ void __launch_bounds__(kThreads)
    masked_h_finish(const float* __restrict__ part, const float* __restrict__ h, float lam,
                    int n, int k, int splits, bool kl, float* __restrict__ out) {
  const long long plane = (long long)k * n;
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= plane) return;
  float nu = 0.f, de = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    nu += part[2 * sp * plane + o];
    de += part[(2 * sp + 1) * plane + o];
  }
  const float hv = h[o];
  if (kl) {
    const float cv = hv * nu;
    const float den = de + sqrtf(de * de + 4.f * lam * cv);
    out[o] = den > 0.f ? 2.f * cv / den : hv;
  } else {
    out[o] = hv * nu / (de + lam * hv + kEps);
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
                     float lam, int m, int n, int k, bool kl, float* part, int splits,
                     float* out, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  const MT* mk = static_cast<const MT*>(mv);
  const int tiles_per = ceil_div(ceil_div(m, kHTile), splits);
  const dim3 grid(ceil_div(n, kHTile), splits, ceil_div(k, kHTile));
  cudaError_t err = launch(masked_h_tc_kernel<XT, MT>, grid, sizeof(HSmem), s, x, mk, w, h, m,
                           n, k, tiles_per, kl, k % 4 == 0 && aligned16(w),
                           n % 4 == 0 && aligned16(h), part);
  if (err != cudaSuccess) return err;
  const long long plane = (long long)k * n;
  masked_h_finish<<<(unsigned)((plane + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, h, lam, n, k, splits, kl, out);
  return cudaGetLastError();
}

// One half-update for the (X type, mask type) pair of a call: mask_is_byte
// selects 1-byte masks, else the mask has X's type.
// part / splits: the H pass's scratch and row splits (unused by the W pass).
cudaError_t masked_update(bool h_pass, int x_is_bf16, int mask_is_byte, const void* x,
                          const void* mask, const float* w, const float* h, float lam,
                          int m, int n, int k, bool kl, float* part, int splits, float* out,
                          cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  using byte = unsigned char;
  if (x_is_bf16) {
    if (mask_is_byte)
      return h_pass ? h_update<bf16, byte>(x, mask, w, h, lam, m, n, k, kl, part, splits, out, s)
                    : w_update<bf16, byte>(x, mask, w, h, lam, m, n, k, kl, out, s);
    return h_pass ? h_update<bf16, bf16>(x, mask, w, h, lam, m, n, k, kl, part, splits, out, s)
                  : w_update<bf16, bf16>(x, mask, w, h, lam, m, n, k, kl, out, s);
  }
  if (mask_is_byte)
    return h_pass ? h_update<float, byte>(x, mask, w, h, lam, m, n, k, kl, part, splits, out, s)
                  : w_update<float, byte>(x, mask, w, h, lam, m, n, k, kl, out, s);
  return h_pass ? h_update<float, float>(x, mask, w, h, lam, m, n, k, kl, part, splits, out, s)
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
      static_cast<const float*>(h), lam, m, n, k, is_kl != 0, nullptr, 0,
      static_cast<float*>(out), static_cast<cudaStream_t>(stream)));
}

// Masked H half-update: out (k, n), with the already-updated W.  X's rows
// are cut into `splits` ranges of whole 64-row tiles (the last may be short
// or empty); part holds 2 * splits * k * n floats of scratch.
int tpunmf_masked_h_update(const void* x, int x_is_bf16, const void* mask, int mask_is_byte,
                           const void* w, const void* h, float lam, int m, int n, int k,
                           int is_kl, void* part, int splits, void* out, void* stream) {
  return static_cast<int>(tpunmf::masked_update(
      true, x_is_bf16, mask_is_byte, x, mask, static_cast<const float*>(w),
      static_cast<const float*>(h), lam, m, n, k, is_kl != 0, static_cast<float*>(part),
      splits, static_cast<float*>(out), static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
