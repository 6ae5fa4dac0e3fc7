// The 2-pass fused MUR iteration: the W half-update and the H half-update,
// each one pass over X with the update fused into its epilogue.
//
// Replaces the Pallas kernels of tpunmf/ops/mur_fused.py:
//   mur_w_update (:169, pallas_call :245): _w_eu_kernel (:76), _w_kl_kernel (:95)
//   mur_w_update(with_lagged_obj=True) (pallas_call :227): _w_kl_obj_kernel (:114)
//   mur_h_update (:750, pallas_call :797): _h_eu_kernel (:708), _h_kl_kernel (:729)
//
// Bound on the H100: every kernel reads X once (4 or 2 bytes a cell) and does
// 2*m*n*k (EU) or 4*m*n*k (KL) flops of products on it, k/2 to k flops per X
// byte.  Up to rank kKlTcRank (H) and kKlWTcRank (W) every pass runs on the
// tensor cores (3xTF32 mma.sync, tf32x3.cuh; one TF32 product a step where
// both operands are bf16 values), where the ridge is 49 flops a byte: the
// EU passes at 8192 x 8192 r128 (1.7e10 flops, 0.104 ms) are bound by their
// products, the KL passes at BASELINE config[1] (20000 x 11000 r50: 880 MB
// of X, 0.263 ms; 4.4e10 flops, 0.267 ms) by both.  Above those ranks the
// KL passes run plain shared-memory FMA tiles (common.cuh).
//
// Design:
//  * EU W pass: mur_iteration_eu's W side without stage (B) and the Gram
//    (wave.cuh): den = W Gh (eu_den_kernel), then X round(H)^T as stage (A)
//    on the tensor cores (eu_rows_tc_kernel: 128 x 128 tiles over the
//    plan's column chunks, one partial a chunk, every step rounded to
//    nearest; H pre-cast to X's type by the wrapper, as
//    tpunmf/ops/mur_fused.py:84 rounds it), then eu_w_kernel adds the
//    chunks' partials in a fixed order and applies the update.  With the
//    plan of mur_iteration_eu (make_plan, kWaveEuTc: all of X in one wave)
//    it gives that pass's W' bit for bit.  The scratch holds the partials
//    and then den; tpunmf_mur_w_eu_scratch tells the wrapper its length.
//  * KL W pass up to rank kKlWTcRank: masked_update.cu's W pass with M = 1
//    (kl_w_pass: a block owns 64 rows of W, one 64-wide chunk of k
//    and one of `splits` ranges of X's columns; S = W_i H_j from the tensor
//    cores' S tile over all k, X loaded in S's fragment layout, zero
//    numerators by div_zero_first, one product H_j[chunk] P^T a step; with
//    one split MUR's update with b = rowsum(H) in the epilogue, with more a
//    partial sum a split and a finish that adds them in split order).  The
//    wrapper picks the splits from the shape, and pads H's
//    rows to a multiple of 4 floats.  Each chunk of k forms S anew, so the
//    work grows with k / 64; above kKlWTcRank the FMA body w_kl_kernel,
//    which forms S once, is faster.
//  * EU H pass: numer = round(W)^T X is wave.cuh's stage (B) on the tensor
//    cores (128 x 128 tiles of k by columns of H; W rounded to X's dtype as
//    its tile lands, mur_fused.py:716; each 8-deep step rounded to nearest,
//    since the numerator feeds the Gram objective) over `splits`
//    ranges of X's rows, each writing a partial sum; h_eu_finish adds the
//    partials in split order, forms Gw*H on a 64 x 64 FMA tile (2 k^2 n
//    flops, 1.6% of the products at r128) and applies the update.  The
//    splits (chosen by the wrapper from the shape, ops/mur_fused.py) fill
//    the card where the column tiles alone would not: 64 tiles at 8192^2.
//  * KL above the tensor-core ranks (w_kl_kernel, h_kl_kernel): the ratio
//    X / (W H + eps) needs S = W_i H_j over the full rank, so a block owns
//    whole rows of W (or whole columns of H) and loops over the other axis
//    of X: per step it forms S in registers on FMA tiles, writes
//    P = X/(S+eps) to shared memory, and adds P H_j^T (or W_i^T P) into a
//    (rows x k) accumulator held in dynamic shared memory (at most 135 KB at
//    k = 1024; the block is halved in that direction above k = 512).  X is
//    upcast to f32, as on the TPU (mur_fused.py:103, :737).
//  * KL H pass up to rank kKlTcRank: masked_update.cu's H pass with M = 1
//    (kl_h_pass: S from the tensor cores' S tile, X loaded in S's fragment
//    layout, zero numerators by div_zero_first, W_i^T P a step per 64-row
//    chunk of k, row splits and a fixed-order finish).  Each chunk of k
//    forms S anew, so the work grows with k / 64; above kKlTcRank the FMA
//    body h_kl_kernel, which forms S once, is faster.
//  * The lagged W pass (kl_w_pass with partials, or w_kl_kernel<..., LAGGED =
//    true> above kKlWTcRank) is the KL W pass's own template and also sums
//    the masked KL of the incoming (W, H) from the same S tiles, with the
//    raw S (no eps) in the log, as mur_fused.py:134-138; its W' is the plain
//    pass's bit for bit.  The TPU added into one SMEM scalar over its
//    sequential grid; here each block writes one partial (on the tensor
//    cores only the blocks of the first chunk of k, one a row tile and
//    split) and reduce_partials_into (objective.cu) adds them in a fixed
//    order, so the sum is bit-reproducible run to run.  No float atomics.
//  * Ragged edges are masked by zero loads and bounds-checked stores, so any
//    (m, n, k <= 1024) works; the TPU needed dividing blocks.
//  * Nothing is written in place: the wrapper allocates fresh outputs.
// Built without --use_fast_math: division and sqrtf stay IEEE.
#include "wave.cuh"

namespace tpunmf {

// MUR's KL passes on the tensor cores (masked_update.cu).
cudaError_t kl_h_pass(const void* x, int x_is_bf16, const float* w, const float* h,
                      const float* wsum, float lam, int m, int n, int k, float* part,
                      int splits, float* h_out, float* numer, cudaStream_t s);
cudaError_t kl_w_pass(const void* x, int x_is_bf16, const float* w, const float* h, int ldh,
                      const float* hsum, float lam, int m, int n, int k, int splits,
                      float* part, float* out, float* partials, cudaStream_t s);
int kl_w_partials(int m, int splits);

namespace {

// The highest rank at which the KL H pass takes the tensor cores (above it,
// the FMA body h_kl_kernel): ops/mur_fused.py's KL_H_TC_RANK.  On an H100 at
// 8192 x 4096 the tensor-core body won at k 640 and lost at k 768 (PERF.md,
// tools/kernel_turns.py).
constexpr int kKlTcRank = 640;
// The same line for the KL W pass (above it, w_kl_kernel):
// ops/mur_fused.py's KL_W_TC_RANK.  On an H100 at 8192 x 4096 the
// tensor-core body won at k 320 (3.33 against 3.82 ms) and lost at k 384
// (4.53 against 4.47): the FMA W body forms S once and keeps up better
// than the FMA H body (PERF.md, tools/kernel_turns.py).
constexpr int kKlWTcRank = 320;

// Partials of the lagged W pass at (m, k) over `splits` column ranges: one a
// row tile and split on the tensor cores, one a row block of the FMA body.
inline int w_lagged_blocks(int m, int k, int splits) {
  return k <= kKlWTcRank ? kl_w_partials(m, splits) : ceil_div(m, kl_block(k));
}

// ----------------------------------------------------------------- EU, W pass
// W' = W * (X round(H)^T) / (W Gh + lam W + eps) in three launches: den =
// W Gh, stage (A) over the plan's column chunks into the partials, and the
// update (wave.cuh).  hc is H (k, n) in X's type; scratch holds
// w_eu_scratch(m, n, k, sizeof(XT)) floats: the partials, then den.
inline long long w_eu_scratch(int m, int n, int k, int x_bytes) {
  const Plan p = make_plan(m, n, k, x_bytes, kWaveEuTc);
  return (long long)p.nsplit * p.rows * k + (long long)m * k;
}

template <typename XT>
cudaError_t w_eu_pass(const XT* x, const XT* hc, const float* w, const float* gh, float lam,
                      int m, int n, int k, float* out, float* scratch, cudaStream_t s) {
  const Plan p = make_plan(m, n, k, sizeof(XT), kWaveEuTc);
  float* part = scratch;
  float* den = scratch + (long long)p.nsplit * p.rows * k;
  cudaError_t err =
      launch(eu_den_kernel, dim3(ceil_div(m, kTile), ceil_div(k, kTile)), 0, s, w, gh, m, k, den);
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(XT);
  const bool aligned = n % V == 0 && aligned16(x) && aligned16(hc);
  err = TcStages<XT>::rows(p, x, hc, m, n, k, 0, m, aligned, part, s);
  if (err != cudaSuccess) return err;
  return launch(eu_w_kernel, elementwise_grid((long long)m * k), 0, s, w,
                static_cast<const float*>(den), static_cast<const float*>(part), p.nsplit, lam,
                static_cast<const float*>(nullptr), k, 0, m, p.rows, out);
}

// ----------------------------------------------------------------- EU, H pass
// After the tensor-core product (wave.cuh, tc_cols): numer = the splits'
// partials added in split order, h_out = H * numer / (Gw H + lam H + eps);
// grid (ceil(n/64), ceil(k/64)).  Where splits == 1, part is numer itself.
__global__ void __launch_bounds__(kThreads)
    h_eu_finish(const float* part, int splits, const float* __restrict__ gw,
                const float* __restrict__ h, float lam, int n, int k,
                float* __restrict__ h_out, float* numer_out) {
  constexpr int LD = kTile + 1;
  __shared__ EuStage st;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;

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

  const long long plane = (long long)k * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gr = c0 + ty + 16 * a, gj = col0 + tx + 16 * b;
      if (gr < k && gj < n) {
        const long long o = (long long)gr * n + gj;
        float nu = 0.f;
        for (int sp = 0; sp < splits; ++sp) nu += part[sp * plane + o];
        const float hv = h[o];
        numer_out[o] = nu;
        h_out[o] = hv * nu / (den[a][b] + lam * hv + kEps);
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

// The KL W half-update, with the lagged objective where partials is not
// null: up to kKlWTcRank on the tensor cores (H read at row stride ldh;
// splits and part as kl_w_pass takes them), above it the FMA
// body (ldh == n; the rows and splits are its own).  Both forms of each
// body are one template, so the lagged W' is the plain one bit for bit.
template <typename XT>
cudaError_t w_kl_update(const XT* x, const float* w, const float* h, int ldh,
                        const float* hsum, float lam, int m, int n, int k, int splits,
                        float* part, float* out, float* partials, cudaStream_t s) {
  if (k <= kKlWTcRank)
    return kl_w_pass(x, std::is_same_v<XT, __nv_bfloat16>, w, h, ldh, hsum, lam, m, n, k,
                     splits, part, out, partials, s);
  if (ldh != n) return cudaErrorInvalidValue;
  const int kpad = ceil_div(k, kTile) * kTile, bm = kl_block(k);
  const size_t smem = bm * (kpad + 1) * sizeof(float);
  const dim3 grid(ceil_div(m, bm));
  if (partials != nullptr)
    return bm == 64 ? launch(w_kl_kernel<XT, 4, true>, grid, smem, s, x, w, h, hsum, lam, m, n,
                             k, kpad, out, partials)
                    : launch(w_kl_kernel<XT, 2, true>, grid, smem, s, x, w, h, hsum, lam, m, n,
                             k, kpad, out, partials);
  return bm == 64 ? launch(w_kl_kernel<XT, 4, false>, grid, smem, s, x, w, h, hsum, lam, m, n,
                           k, kpad, out, partials)
                  : launch(w_kl_kernel<XT, 2, false>, grid, smem, s, x, w, h, hsum, lam, m, n,
                           k, kpad, out, partials);
}

// Whether the scratch of the KL W pass on the tensor cores holds its
// partial sums (none for one split).
inline bool kl_w_fits(int m, int k, int splits, long long scratch_len) {
  if (k > kKlWTcRank) return true;
  return splits >= 1 && (splits == 1 || scratch_len >= (long long)splits * m * k);
}

// The H half-update.  The tensor-core passes cut X's rows into `splits`
// ranges of whole 64-row tiles (the last may be short or empty), each
// adding into its own k x n partial in part; where splits == 1 the partial
// is numer itself.
template <typename XT>
cudaError_t h_update(const void* xv, const float* w, const float* h, const float* aux,
                     float lam, int m, int n, int k, bool kl, float* part, int splits,
                     float* h_out, float* numer, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  float* sums = splits > 1 ? part : numer;
  if (!kl) {
    const int rows = ceil_div(ceil_div(m, kTile), splits) * kTile;
    cudaError_t err = tc_cols(x, w, n, k, 0, m, rows, splits, true, numer, sums, s);
    if (err != cudaSuccess) return err;
    return launch(h_eu_finish, dim3(ceil_div(n, kTile), ceil_div(k, kTile)), 0, s,
                  static_cast<const float*>(sums), splits, aux, h, lam, n, k, h_out, numer);
  }
  if (k <= kKlTcRank)
    return kl_h_pass(xv, std::is_same_v<XT, __nv_bfloat16>, w, h, aux, lam, m, n, k, sums,
                     splits, h_out, numer, s);
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

// Floats of scratch the EU W half-update needs at (m, n, k) for X of
// x_bytes (4 f32, 2 bf16) an element: the plan's partials and m * k.
long long tpunmf_mur_w_eu_scratch(int m, int n, int k, int x_bytes) {
  return tpunmf::w_eu_scratch(m, n, k, x_bytes);
}

// W half-update.  EU: h is H (k, n) in X's type, aux is Gh = H H^T (k, k),
// scratch holds scratch_len floats, at least tpunmf_mur_w_eu_scratch's
// (fewer: cudaErrorInvalidValue), ldh is n, splits is not read.  KL: h is
// H (k, n) f32 at row stride ldh (>= n, its columns n..ldh zero; ldh == n
// above the tensor-core rank), aux is rowsum(H) (k,); on the tensor cores
// over `splits` ranges of X's columns, scratch holding splits * m * k
// floats of partial sums where splits > 1.
int tpunmf_mur_w_update(const void* x, int x_is_bf16, const void* w, const void* h, int ldh,
                        const void* aux, float lam, int m, int n, int k, int is_kl, int splits,
                        void* scratch, long long scratch_len, void* out, void* stream) {
  using namespace tpunmf;
  const float* wf = static_cast<const float*>(w);
  const float* af = static_cast<const float*>(aux);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = x_is_bf16 != 0;
  if (ldh < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_kl) {
    if (ldh != n || scratch_len < w_eu_scratch(m, n, k, bf16 ? 2 : 4))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        bf16 ? w_eu_pass(static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(h), wf, af, lam, m, n, k, o, sc, s)
             : w_eu_pass(static_cast<const float*>(x), static_cast<const float*>(h), wf, af,
                         lam, m, n, k, o, sc, s));
  }
  if (!kl_w_fits(m, k, splits, scratch_len)) return static_cast<int>(cudaErrorInvalidValue);
  const float* hf = static_cast<const float*>(h);
  return static_cast<int>(
      bf16 ? w_kl_update(static_cast<const __nv_bfloat16*>(x), wf, hf, ldh, af, lam, m, n, k,
                         splits, sc, o, nullptr, s)
           : w_kl_update(static_cast<const float*>(x), wf, hf, ldh, af, lam, m, n, k, splits,
                         sc, o, nullptr, s));
}

// Rows of partials tpunmf_mur_w_update_lagged needs at (m, k) with its
// splits.
int tpunmf_mur_w_lagged_blocks(int m, int k, int splits) {
  return tpunmf::w_lagged_blocks(m, k, splits);
}

// KL W half-update that also writes the masked KL of the incoming (W, H) to
// obj[0] (the lagged objective).  h, ldh, splits and scratch as
// tpunmf_mur_w_update's KL pass; hsum is rowsum(H) (k,); partials holds
// tpunmf_mur_w_lagged_blocks(m, k, splits) floats of scratch.
int tpunmf_mur_w_update_lagged(const void* x, int x_is_bf16, const void* w, const void* h,
                               int ldh, const void* hsum, float lam, int m, int n, int k,
                               int splits, void* scratch, long long scratch_len, void* out,
                               void* partials, void* obj, void* stream) {
  using namespace tpunmf;
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  const float* hs = static_cast<const float*>(hsum);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ldh < n || !kl_w_fits(m, k, splits, scratch_len))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      x_is_bf16 ? w_kl_update(static_cast<const __nv_bfloat16*>(x), wf, hf, ldh, hs, lam, m, n,
                              k, splits, sc, o, p, s)
                : w_kl_update(static_cast<const float*>(x), wf, hf, ldh, hs, lam, m, n, k,
                              splits, sc, o, p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_partials_into(
      p, w_lagged_blocks(m, k, splits), 1.f, static_cast<float*>(obj), s));
}

// H half-update.  aux is Gw = W^T W (k, k) for EU, colsum(W) (k,) for KL.
// Writes the updated H and the raw numerator, both (k, n).  X's rows are
// cut into `splits` ranges of whole 64-row tiles (the last may be short or
// empty); part holds splits * k * n floats of scratch where splits > 1 and
// is not read where splits == 1.  The KL pass above rank kKlTcRank (the
// FMA body) reads neither.
int tpunmf_mur_h_update(const void* x, int x_is_bf16, const void* w, const void* h,
                        const void* aux, float lam, int m, int n, int k, int is_kl,
                        void* part, int splits, void* h_out, void* numer, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  const float* af = static_cast<const float*>(aux);
  float* pt = static_cast<float*>(part);
  float* ho = static_cast<float*>(h_out);
  float* nu = static_cast<float*>(numer);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      x_is_bf16
          ? tpunmf::h_update<__nv_bfloat16>(x, wf, hf, af, lam, m, n, k, is_kl, pt, splits, ho,
                                            nu, s)
          : tpunmf::h_update<float>(x, wf, hf, af, lam, m, n, k, is_kl, pt, splits, ho, nu, s);
  return static_cast<int>(err);
}

}  // extern "C"
