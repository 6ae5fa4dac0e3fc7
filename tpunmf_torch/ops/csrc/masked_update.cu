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
// against the same factor tile) on one read of X and M.  Bound on the H100,
// with the products at 3xTF32 (165 TFLOP/s of f32 work, tf32x3.cuh): 6mnk =
// 2.865e11 flops at MovieLens-10M's 69878 x 10677, k 64, take 1.736 ms,
// above the 1.121 ms of reading X (f32) and a uint8 M, so the products bound
// both passes.  Both run on the tensor cores in 3xTF32 mma.sync, with S
// from tf32x3.cuh's S tile (over all k; W and H by 16-byte cp.async in
// 32-deep chunks), and X and M loaded into registers before S is formed,
// each thread loading the cells of its own S entries (a row of X starts on
// 16 bytes only where n % 4 == 0, and MovieLens-10M's n = 10677 is odd;
// loaded in S's layout they need no shared tile and no barrier).  Each step
// writes P_n and P_d (EU: M*X and M*S; KL: M*X / (S + eps) and M) to shared
// memory and adds two products against one factor tile into two 64 x 64
// accumulators held in registers, the two sums sharing each step's
// fragments of that tile.  The W pass's two sums, about 1,300 8-deep steps
// along n at MovieLens-10M, take each step's products into fresh
// accumulators added to both sums with round to nearest (warp_mma2's
// ROUNDED, tf32x3.cuh), as MUR's KL numerators below do: with the tensor
// cores' own sums, whose truncation falls one way, masked MUR's kernel
// route sat up to 4 times the plain f32 route's distance from float64
// over 50 iterations on an H100, with W's rounded within 1.96 times
// (chip_smoke.py's F64_NEAR_PLAIN gate is 2.5); it costs the W pass
// 3.5-3.9% at MovieLens-10M.  The H pass's sums (about 670 steps a row
// split) keep the tensor cores' own: rounding them too took 1.96 to 1.07
// times, inside that gate either way, and cost the H pass 5.5-5.7%.  A
// zero numerator of KL's P_n (most cells: M is 98.7% zeros at
// MovieLens-10M) skips the division's slow path (div_zero_first, the same
// bits).  A rank above 64 takes more 64-wide chunks of k, each forming S
// again.
//
// The W pass: a block owns BM rows of W (and of X) and one chunk of k, and
// walks all of n in 64-column steps; for each it forms S = W_i H_j, copies
// H[chunk, j-range] into shared memory (row stride 4 mod 32: it is the A
// operand, read along its rows, and P_n, P_d are B, read column by column
// in mma's .col layout), and adds H_j[chunk] P_n^T and H_j[chunk] P_d^T
// (the sums transposed, chunk x rows).  The block sees all of n for its
// rows, so the EU or KL epilogue runs in the block: no partial sums, no
// scratch, the same bits on every call.  H is read through a row stride
// ldh >= n whose columns past n are zero: the wrapper (ops/masked_fused.py)
// pads a copy of H to a multiple of 4 columns where n is not one, so that
// every copy of H goes by 16-byte cp.async.  BM is 64, or 32 where 64
// gives the card less than a wave of blocks.
//
// The H pass: kernel 1's grid is column tiles x row splits x 64-row chunks
// of k; a block owns 64 columns of H, one range of X's rows and 64 rows of
// k, and for each 64-row tile of its range forms S, copies the W_i[:, chunk]
// tile by 16-byte cp.async, and adds W_i^T P_n and W_i^T P_d.  Each block
// writes its two partial sums to a scratch buffer; kernel 2 adds the
// partials of each entry over the splits in a fixed order and applies the
// EU or KL epilogue: the same bits on every call, no float atomics.  The
// row splits (chosen by the wrapper, ops/masked_fused.py) give
// MovieLens-10M's 167 column tiles several blocks for each of the card's
// 132 SMs, where one block over all rows left the card idle.
//
// MUR's KL passes (mur_update.cu) are these passes with M = 1 (NoMask): each
// step sums P = X / (S + eps) alone, one product a step, into a numerator
// whose steps are rounded to nearest (warp_mma's ROUNDED, tf32x3.cuh): the
// tensor cores truncate what they accumulate, and over the thousand steps
// of a numerator at m = 8192 that bias moved MUR KL 1.3e-4 off float64
// after 50 iterations at 8192 x 8192 r128 on an H100; rounded, 1.3e-6 (the
// plain f32 route: 2.7e-7).  S keeps the tensor cores' sums: rounding it
// as well moved nothing measurable and cost 3-5% a pass.  The H pass writes
// one partial sum a split (kl_h_sums), and kl_h_finish adds them and
// applies MUR's KL update (d = colsum(W), no guard); the single-pass KL
// iteration (mur_iteration.cu) adds them into its numerator instead.  The
// W pass also splits X's columns into `splits` ranges of whole 64-column
// tiles (a grid axis; the wrapper picks the count from the shape,
// ops/mur_fused.py), so that BASELINE config[1]'s 313 row tiles make eight
// waves of the card instead of 1.2; with one split it applies MUR's KL
// update in its epilogue (b = rowsum(H), a k-vector formed outside; no
// guard), with more each block writes its raw sums to a partial and
// kl_w_finish adds the partials in split order and applies the update.  Its lagged form also sums the masked KL of the
// incoming (W, H) over its S entries, with the raw S in the log
// (tpunmf/core/losses.py:20-25): only the blocks of the first chunk of k
// add (every chunk forms the same S), each writing one partial that
// reduce_partials_into (objective.cu) adds in a fixed order.
// masked_h_update's instantiations keep their code and bits.
//
// X is f32 or bf16 and M is 1-byte (binary) or X's type (weights); both are
// upcast to f32 and the factors are not rounded to X's type
// (masked_fused.py:86-92, 182-188).  Ragged edges load zeros and bound their
// stores.  Built without --use_fast_math.
#include "common.cuh"
#include "tf32x3.cuh"

namespace tpunmf {
namespace {

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

// The mask of MUR's KL passes (mur_update.cu): M = 1, so a pass sums
// P_n = X / (S + eps) alone; its W^T M (M H^T) is colsum(W) (rowsum(H)), a
// k-vector formed outside.
struct NoMask {};

// Kernel 1: block (column tile, split, k chunk) writes its partial sums
// part[(split * 2 + q) * k * n + c * n + j], q = 0 numerator, 1 denominator
// (EU) or W^T M (KL), for its 64 columns j and 64 rows c of k; with NoMask
// (KL only) the numerator alone, part[split * k * n + c * n + j].  Its rows
// of X are the tiles [split * tiles_per, (split + 1) * tiles_per) of 64.
// `w_aligned` / `h_aligned`: the rows of W / H start on 16 bytes.
template <typename XT, typename MT>
__global__ void __launch_bounds__(kThreads, 2)
    masked_h_tc_kernel(const XT* __restrict__ x, const MT* __restrict__ mask,
                       const float* __restrict__ w, const float* __restrict__ h, int m, int n,
                       int k, int tiles_per, bool kl, bool w_aligned, bool h_aligned,
                       float* __restrict__ part) {
  constexpr bool kMasked = !std::is_same_v<MT, NoMask>;
  using MR = std::conditional_t<kMasked, MT, unsigned char>;  // no mask: unused
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
    MR mr[MTL][NTL][4];
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
          if constexpr (kMasked) mr[i][j][q] = in ? mask[o] : zero_of<MT>();
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
            const float xv = to_f32(xr[i][j][q]), sv = s[i][j][q];
            if constexpr (kMasked) {
              const float mv = to_f32(mr[i][j][q]);
              pn[v] = kl ? div_zero_first(mv * xv, sv + kEps) : xv * mv;
              pd[v] = kl ? mv : mv * sv;
            } else {
              pn[v] = div_zero_first(xv, sv + kEps);
            }
          }
          const int o = (wr + 16 * i + g + 8 * half) * kLdp + wcol + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(sm.u.p.pn + o) = make_float2(pn[0], pn[1]);
          if constexpr (kMasked)
            *reinterpret_cast<float2*>(sm.u.p.pd + o) = make_float2(pd[0], pd[1]);
        }
    __syncthreads();
    // acc += W_i[:, chunk]^T P over the tile's 64 rows (A read transposed,
    // once for both sums); MUR's numerator rounds each step's sum
    if constexpr (kMasked)
      tc::warp_mma2<MTL, NTL, true>(acc_n, acc_d, sm.wc, kLdp, sm.u.p.pn, sm.u.p.pd, kLdp, wr,
                                    wcol, kHTile, lane);
    else
      tc::warp_mma<MTL, NTL, true, true>(acc_n, sm.wc, kLdp, sm.u.p.pn, kLdp, wr, wcol, kHTile,
                                         lane);
    __syncthreads();  // the tiles are read before the next step's copies land
  }

  const long long plane = (long long)k * n;
  float* out_n = part + (kMasked ? 2 : 1) * split * plane;
  auto store = [&](float* out, const tc::Acc<MTL, NTL>& acc) {
    tc::for_pairs<MTL, NTL>(acc, wr, wcol, lane, [&](int r, int c, float v0, float v1) {
      const int gk = c0 + r, gc = col0 + c;
      if (gk >= k) return;
      if (gc < n) out[(long long)gk * n + gc] = v0;
      if (gc + 1 < n) out[(long long)gk * n + gc + 1] = v1;
    });
  };
  store(out_n, acc_n);
  if constexpr (kMasked) store(out_n + plane, acc_d);
}

// ------------------------------------------------------------------ W pass
constexpr int kWLd = kHTile + 4;  // P_n, P_d and the H chunk: row stride = 4 (mod 32)

// A W block of BM rows: S = W_i H_j as BM x 64 (warps 2 x 4), and the sums
// transposed, acc[c][r] for the chunk's 64 columns c of k and the block's
// rows r, as 64 x BM (warps 2 x 4, 32 x BM/4 each).
template <int BM>
struct WPass {
  using S = tc::STile<BM, kHTile, 2, 4>;
  static constexpr int MT = kHTile / 2 / 16, NT = BM / 4 / 8;
  static constexpr int WROWS = kHTile / 2, WCOLS = BM / 4;
  // Dynamic shared memory: the S tile's staging, reused for P_n and P_d
  // (pn[r][j] = P_n[row0 + r][j0 + j]); the H chunk (hc[c][j] = H[c0 + c][j0 + j]).
  struct Smem {
    union {
      typename S::Stage stage;
      struct {
        alignas(16) float pn[BM * kWLd];
        alignas(16) float pd[BM * kWLd];
      } p;
    } u;
    alignas(16) float hc[kHTile * kWLd];
  };
};

// The W pass's body: block (row tile, k chunk) writes out[r][c0 + c] for
// its BM rows r of W and the chunk's 64 columns c, from X's columns
// [j_begin, j_end).  H is read at row stride ldh (>= n; columns n..ldh
// zero).  `w_aligned` / `h_aligned`: the rows of W / H start on 16 bytes.
// The masked pass (masked_w_tc_kernel) walks all of n and reads neither
// hsum, part nor partials.  With NoMask (MUR's KL pass, kl_w_tc_kernel,
// split z = blockIdx.z of X's columns): one split applies MUR's KL update
// with b = hsum[c]; more write the raw sums to part[z][r][c] (m x k a
// split) for kl_w_finish.  LAGGED: the blocks of chunk 0 also write
// partials[z * gridDim.x + blockIdx.x], the masked KL of (X, S) over their
// cells.
template <typename XT, typename MT, int BM, bool LAGGED>
__device__ __forceinline__ void w_tc_body(
    const XT* __restrict__ x, const MT* __restrict__ mask, const float* __restrict__ w,
    const float* __restrict__ h, int ldh, const float* __restrict__ hsum, float lam, int m,
    int n, int k, int j_begin, int j_end, bool kl, bool w_aligned, bool h_aligned,
    float* __restrict__ out, float* __restrict__ part, float* __restrict__ partials) {
  constexpr bool kMasked = !std::is_same_v<MT, NoMask>;
  static_assert(kMasked ? !LAGGED : true, "the lagged objective is MUR's (M = 1)");
  using MR = std::conditional_t<kMasked, MT, unsigned char>;  // no mask: unused
  using WP = WPass<BM>;
  using ST = typename WP::S;
  constexpr int SMT = ST::MT, SNT = ST::NT;
  extern __shared__ float4 smem_raw[];
  typename WP::Smem& sm = *reinterpret_cast<typename WP::Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BM, c0 = blockIdx.y * kHTile;
  const int rows = min(BM, m - row0);
  // the warp's piece of S: rows [sr, sr + BM/2), columns [sc, sc + 16) of
  // the step; of the sums: chunk columns [ar, ar + 32), rows [acol, acol + BM/4)
  const int sr = ST::warp_row(warp), sc = ST::warp_col(warp);
  const int ar = (warp / 4) * WP::WROWS, acol = (warp % 4) * WP::WCOLS;
  const int g = lane >> 2, t = lane & 3;
  // LAGGED: this thread's cells of the objective (chunk 0 only)
  const bool sums_obj = LAGGED && blockIdx.y == 0;
  double obj = 0.0;

  tc::Acc<WP::MT, WP::NT> acc_n, acc_d;
  tc::zero(acc_n);
  tc::zero(acc_d);
  for (int j0 = j_begin; j0 < j_end; j0 += kHTile) {
    // the H chunk: one cp.async group, complete by the S tile's first wait
    for (int l = tid; l < kHTile * kHTile / 4; l += kThreads) {
      const int r = l / (kHTile / 4), c = l % (kHTile / 4) * 4;
      stage_piece(sm.hc + r * kWLd + c, h + (long long)(c0 + r) * ldh + j0 + c,
                  c0 + r < k ? ldh - j0 - c : 0, h_aligned);
    }
    cp_async_commit();
    // X and M at the cells of this thread's S entries, in flight while the
    // tensor cores form S (zero outside X)
    XT xr[SMT][SNT][4];
    MR mr[SMT][SNT][4];
#pragma unroll
    for (int i = 0; i < SMT; ++i)
#pragma unroll
      for (int j = 0; j < SNT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = sr + 16 * i + g + (q >> 1) * 8, c = j0 + sc + 8 * j + 2 * t + (q & 1);
          const bool in = r < rows && c < j_end;
          const long long o = (long long)(row0 + r) * n + c;
          xr[i][j][q] = in ? x[o] : zero_of<XT>();
          if constexpr (kMasked) mr[i][j][q] = in ? mask[o] : zero_of<MT>();
        }

    tc::Acc<SMT, SNT> s;
    tc::s_tile<BM, kHTile, 2, 4>(s, w, h, m, ldh, k, row0, j0, w_aligned, h_aligned,
                                 sm.u.stage);  // ends with a barrier
    // P_n, P_d (zero outside X, where X and M are 0)
    float tile_obj = 0.f;
#pragma unroll
    for (int i = 0; i < SMT; ++i)
#pragma unroll
      for (int j = 0; j < SNT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pn[2], pd[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int q = 2 * half + v;
            if constexpr (kMasked) {  // this order fixes masked_w_update's machine code
              const float xv = to_f32(xr[i][j][q]), mv = to_f32(mr[i][j][q]), sv = s[i][j][q];
              pn[v] = kl ? div_zero_first(mv * xv, sv + kEps) : xv * mv;
              pd[v] = kl ? mv : mv * sv;
            } else {
              const float xv = to_f32(xr[i][j][q]), sv = s[i][j][q];
              pn[v] = div_zero_first(xv, sv + kEps);
              if constexpr (LAGGED)  // the raw S, cells inside X only
                if (sums_obj && sr + 16 * i + g + 8 * half < rows &&
                    j0 + sc + 8 * j + 2 * t + v < j_end)
                  tile_obj += kl_term_sparse(xv, sv);
            }
          }
          const int o = (sr + 16 * i + g + 8 * half) * kWLd + sc + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(sm.u.p.pn + o) = make_float2(pn[0], pn[1]);
          if constexpr (kMasked)
            *reinterpret_cast<float2*>(sm.u.p.pd + o) = make_float2(pd[0], pd[1]);
        }
    if constexpr (LAGGED) obj += tile_obj;  // zero outside chunk 0
    __syncthreads();
    // acc[c][r] += sum_j H[c0 + c][j0 + j] P[r][j] (the H chunk's fragments
    // once for both sums; P read in .col layout); every sum rounds each
    // step's products
    if constexpr (kMasked)
      tc::warp_mma2<WP::MT, WP::NT, false, true, true>(acc_n, acc_d, sm.hc, kWLd, sm.u.p.pn,
                                                      sm.u.p.pd, kWLd, ar, acol, kHTile, lane);
    else
      tc::warp_mma<WP::MT, WP::NT, false, true, true>(acc_n, sm.hc, kWLd, sm.u.p.pn, kWLd,
                                                      ar, acol, kHTile, lane);
    __syncthreads();  // the tiles are read before the next step's copies land
  }

  // the epilogue, each entry from both sums: rows ar + 16 i + g (+8) of the
  // accumulator tiles are columns of the chunk, columns acol + 8 j + 2 t (+1)
  // rows of W
#pragma unroll
  for (int i = 0; i < WP::MT; ++i)
#pragma unroll
    for (int j = 0; j < WP::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gk = c0 + ar + 16 * i + g + (q >> 1) * 8;
        const int gr = row0 + acol + 8 * j + 2 * t + (q & 1);
        if (gk >= k || gr >= m) continue;
        const long long o = (long long)gr * k + gk;
        if constexpr (kMasked) {
          const float wv = w[o], nu = acc_n[i][j][q], de = acc_d[i][j][q];
          if (kl) {
            const float a = wv * nu;
            const float den = de + sqrtf(de * de + 4.f * lam * a);
            out[o] = den > 0.f ? 2.f * a / den : wv;
          } else {
            out[o] = wv * nu / (de + lam * wv + kEps);
          }
        } else {  // MUR's KL update, no guard (or the raw sums)
          const float wv = w[o], nu = acc_n[i][j][q];
          if (gridDim.z > 1) {
            part[blockIdx.z * (long long)m * k + o] = nu;
          } else {
            const float a = wv * nu, b = hsum[gk];
            out[o] = 2.f * a / (b + sqrtf(b * b + 4.f * lam * a));
          }
        }
      }
  if constexpr (LAGGED) {
    if (sums_obj) {  // uniform over the block
      const double sum = block_sum(obj);
      if (tid == 0) partials[blockIdx.z * gridDim.x + blockIdx.x] = (float)sum;
    }
  }
}

// Block (row tile, k chunk) of the masked W pass, over all of X's columns.
template <typename XT, typename MT, int BM>
__global__ void __launch_bounds__(kThreads, 2)
    masked_w_tc_kernel(const XT* __restrict__ x, const MT* __restrict__ mask,
                       const float* __restrict__ w, const float* __restrict__ h, int ldh,
                       float lam, int m, int n, int k, bool kl, bool w_aligned, bool h_aligned,
                       float* __restrict__ out) {
  w_tc_body<XT, MT, BM, false>(x, mask, w, h, ldh, nullptr, lam, m, n, k, 0, n, kl, w_aligned,
                               h_aligned, out, nullptr, nullptr);
}

// Rows of W a block of MUR's KL W pass owns (32-row blocks lost at BASELINE
// config[1] and at 8192 x 4096 r128 on an H100: PERF.md).
constexpr int kKlWRows = 64;

// Block (row tile, k chunk, split z) of MUR's KL W pass: the body with M = 1
// over X's columns [z * cols, (z + 1) * cols).
template <typename XT, bool LAGGED>
__global__ void __launch_bounds__(kThreads, 2)
    kl_w_tc_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ h, int ldh, const float* __restrict__ hsum,
                   float lam, int m, int n, int k, int cols, bool w_aligned, bool h_aligned,
                   float* __restrict__ out, float* __restrict__ part,
                   float* __restrict__ partials) {
  const int j_begin = blockIdx.z * cols;
  w_tc_body<XT, NoMask, kKlWRows, LAGGED>(x, static_cast<const NoMask*>(nullptr), w, h, ldh,
                                          hsum, lam, m, n, k, j_begin, min(n, j_begin + cols),
                                          true, w_aligned, h_aligned, out, part, partials);
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

// MUR's KL H pass, kernel 2: numer = the splits' partials added in split
// order (one plane a split), c = H * numer, d = colsum(W) (k,);
// h_out = 2c / (d + sqrt(d^2 + 4 lam c)), with no guard, as mur_update.cu's
// FMA body.  Where splits == 1, part may be numer itself.
__global__ void __launch_bounds__(kThreads)
    kl_h_finish(const float* part, const float* __restrict__ h,
                const float* __restrict__ wsum, float lam, int n, int k, int splits,
                float* __restrict__ h_out, float* numer) {
  const long long plane = (long long)k * n;
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= plane) return;
  float nu = 0.f;
  for (int sp = 0; sp < splits; ++sp) nu += part[sp * plane + o];
  numer[o] = nu;
  const float cv = h[o] * nu, d = wsum[o / n];
  h_out[o] = 2.f * cv / (d + sqrtf(d * d + 4.f * lam * cv));
}

// MUR's KL W pass, after the kernel where it split X's columns: the
// splits' partial sums added in split order, a = W * numer, b = hsum (k,);
// out = 2a / (b + sqrt(b^2 + 4 lam a)), with no guard.
__global__ void __launch_bounds__(kThreads)
    kl_w_finish(const float* __restrict__ part, const float* __restrict__ w,
                const float* __restrict__ hsum, float lam, int m, int k, int splits,
                float* __restrict__ out) {
  const long long plane = (long long)m * k;
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= plane) return;
  float nu = 0.f;
  for (int sp = 0; sp < splits; ++sp) nu += part[sp * plane + o];
  const float a = w[o] * nu, b = hsum[o % k];
  out[o] = 2.f * a / (b + sqrtf(b * b + 4.f * lam * a));
}

template <int BM, typename XT, typename MT>
cudaError_t w_update(const XT* x, const MT* mk, const float* w, const float* h, int ldh,
                     float lam, int m, int n, int k, bool kl, float* out, cudaStream_t s) {
  const dim3 grid(ceil_div(m, BM), ceil_div(k, kHTile));
  return launch(masked_w_tc_kernel<XT, MT, BM>, grid, sizeof(typename WPass<BM>::Smem), s, x,
                mk, w, h, ldh, lam, m, n, k, kl, k % 4 == 0 && aligned16(w),
                ldh % 4 == 0 && aligned16(h), out);
}

template <typename XT, typename MT>
cudaError_t h_update(const XT* x, const MT* mk, const float* w, const float* h, float lam,
                     int m, int n, int k, bool kl, float* part, int splits, float* out,
                     cudaStream_t s) {
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

// f(x, mask) with X and M cast to the (X type, mask type) pair of a call:
// mask_is_byte selects 1-byte masks, else the mask has X's type.
template <typename F>
cudaError_t with_types(int x_is_bf16, int mask_is_byte, const void* x, const void* mask, F f) {
  using bf16 = __nv_bfloat16;
  using byte = unsigned char;
  if (x_is_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    return mask_is_byte ? f(xb, static_cast<const byte*>(mask))
                        : f(xb, static_cast<const bf16*>(mask));
  }
  const float* xf = static_cast<const float*>(x);
  return mask_is_byte ? f(xf, static_cast<const byte*>(mask))
                      : f(xf, static_cast<const float*>(mask));
}

}  // namespace

// MUR's KL H numerator W^T (X / (W H + eps)) on the tensor cores: kernel 1
// of the masked H pass with M = 1 over `splits` row ranges, one k x n
// partial sum a split in part (splits * k * n floats; where splits == 1,
// part may be the numerator itself).
cudaError_t kl_h_sums(const void* x, int x_is_bf16, const float* w, const float* h, int m,
                      int n, int k, float* part, int splits, cudaStream_t s) {
  const int tiles_per = ceil_div(ceil_div(m, kHTile), splits);
  const dim3 grid(ceil_div(n, kHTile), splits, ceil_div(k, kHTile));
  const bool w_aligned = k % 4 == 0 && aligned16(w), h_aligned = n % 4 == 0 && aligned16(h);
  const NoMask* none = nullptr;
  return x_is_bf16 ? launch(masked_h_tc_kernel<__nv_bfloat16, NoMask>, grid, sizeof(HSmem), s,
                            static_cast<const __nv_bfloat16*>(x), none, w, h, m, n, k,
                            tiles_per, true, w_aligned, h_aligned, part)
                   : launch(masked_h_tc_kernel<float, NoMask>, grid, sizeof(HSmem), s,
                            static_cast<const float*>(x), none, w, h, m, n, k, tiles_per, true,
                            w_aligned, h_aligned, part);
}

// MUR's KL H half-update (mur_update.cu) on the tensor cores: kl_h_sums,
// then kl_h_finish.  part holds splits * k * n floats, or is numer where
// splits == 1.
cudaError_t kl_h_pass(const void* x, int x_is_bf16, const float* w, const float* h,
                      const float* wsum, float lam, int m, int n, int k, float* part,
                      int splits, float* h_out, float* numer, cudaStream_t s) {
  cudaError_t err = kl_h_sums(x, x_is_bf16, w, h, m, n, k, part, splits, s);
  if (err != cudaSuccess) return err;
  const long long plane = (long long)k * n;
  kl_h_finish<<<(unsigned)((plane + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, h, wsum, lam, n, k, splits, h_out, numer);
  return cudaGetLastError();
}

// The columns a split of MUR's KL W pass walks: whole 64-column tiles,
// ceil(tiles / splits) of them (the last split short).
static int kl_w_cols(int n, int splits) { return ceil_div(ceil_div(n, kHTile), splits) * kHTile; }

// Partials the lagged KL W pass on the tensor cores writes at (m, splits):
// one a row tile and split.
int kl_w_partials(int m, int splits) { return ceil_div(m, kKlWRows) * splits; }

// MUR's KL W half-update (mur_update.cu) on the tensor cores: the masked W
// pass with M = 1, kKlWRows rows a block, H read at row stride ldh, X's
// columns in `splits` ranges of kl_w_cols(n, splits) (where splits > 1,
// part holds splits * m * k floats and kl_w_finish applies the update).
// Where partials is not null (the lagged pass) the blocks of the first
// chunk of k also write kl_w_partials(m, splits) partials of the masked KL
// of the incoming (W, H); the caller adds them.
cudaError_t kl_w_pass(const void* x, int x_is_bf16, const float* w, const float* h, int ldh,
                      const float* hsum, float lam, int m, int n, int k, int splits,
                      float* part, float* out, float* partials, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const dim3 grid(ceil_div(m, kKlWRows), ceil_div(k, kHTile), splits);
  const size_t smem = sizeof(WPass<kKlWRows>::Smem);
  const int cols = kl_w_cols(n, splits);
  const bool w_aligned = k % 4 == 0 && aligned16(w), h_aligned = ldh % 4 == 0 && aligned16(h);
  auto run = [&](auto xt, auto lagged) {
    using XT = std::remove_const_t<std::remove_pointer_t<decltype(xt)>>;
    return launch(kl_w_tc_kernel<XT, decltype(lagged)::value>, grid, smem, s, xt, w, h, ldh,
                  hsum, lam, m, n, k, cols, w_aligned, h_aligned, out, part, partials);
  };
  const bool lag = partials != nullptr;
  cudaError_t err;
  if (x_is_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    err = lag ? run(xb, std::true_type{}) : run(xb, std::false_type{});
  } else {
    const float* xf = static_cast<const float*>(x);
    err = lag ? run(xf, std::true_type{}) : run(xf, std::false_type{});
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long plane = (long long)m * k;
  kl_w_finish<<<(unsigned)((plane + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, w, hsum, lam, m, k, splits, out);
  return cudaGetLastError();
}

}  // namespace tpunmf

extern "C" {

// Masked W half-update: out (m, k).  x (m, n) is f32 or bf16 (x_is_bf16);
// mask (m, n) is 1-byte 0/1 (mask_is_byte) or of x's type.  h is read at
// row stride ldh >= n, its columns n..ldh zero; block_rows (64 or 32) is BM.
int tpunmf_masked_w_update(const void* x, int x_is_bf16, const void* mask, int mask_is_byte,
                           const void* w, const void* h, int ldh, float lam, int m, int n,
                           int k, int is_kl, int block_rows, void* out, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ldh < n || (block_rows != 64 && block_rows != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      tpunmf::with_types(x_is_bf16, mask_is_byte, x, mask, [&](auto xt, auto mt) {
        return block_rows == 64
                   ? tpunmf::w_update<64>(xt, mt, wf, hf, ldh, lam, m, n, k, is_kl != 0, o, s)
                   : tpunmf::w_update<32>(xt, mt, wf, hf, ldh, lam, m, n, k, is_kl != 0, o, s);
      }));
}

// Masked H half-update: out (k, n), with the already-updated W.  X's rows
// are cut into `splits` ranges of whole 64-row tiles (the last may be short
// or empty); part holds 2 * splits * k * n floats of scratch.
int tpunmf_masked_h_update(const void* x, int x_is_bf16, const void* mask, int mask_is_byte,
                           const void* w, const void* h, float lam, int m, int n, int k,
                           int is_kl, void* part, int splits, void* out, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  return static_cast<int>(
      tpunmf::with_types(x_is_bf16, mask_is_byte, x, mask, [&](auto xt, auto mt) {
        return tpunmf::h_update(xt, mt, wf, hf, lam, m, n, k, is_kl != 0,
                                static_cast<float*>(part), splits, static_cast<float*>(out),
                                static_cast<cudaStream_t>(stream));
      }));
}

}  // extern "C"
