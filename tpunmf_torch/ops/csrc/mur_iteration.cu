// The single-pass MUR iteration: the whole W half-update and the H
// numerator of one iteration from one read of X in device memory.
//
// Replaces the Pallas kernels of tpunmf/ops/mur_fused.py:
//   mur_iteration_eu (:314, pallas_call :340): _iter_eu_kernel (:259)
//   mur_iteration_eu_dma (:465, pallas_call :484): _iter_eu_dma_kernel (:368)
//   mur_iteration_kl (:652, pallas_call :679): _iter_kl_kernel (:522) and
//       _iter_kl_blocked_kernel (:595); the latter's column sub-blocks (bs)
//       were a VMEM tiling of the TPU, so one design serves both bodies.
//
//   EU: numer = X round(H)^T, W' = W * numer / (W Gh + lam W + eps),
//       wtx = round(W')^T X, gram = W'^T W'          (round: to X's type)
//   KL: a = W * ((X / (W H + eps)) H^T), b = rowsum(H),
//       W' = 2a / (b + sqrt(b^2 + 4 lam a)), wtr = W'^T (X / (W' H + eps)),
//       obj = masked KL of the incoming (W, H), from the W pass's W H tiles
//
// What bounds them on the H100: EU does 4*m*n*k flops of products and KL
// 8*m*n*k on one read of X, k to 2k flops per X byte at f32 (twice that at
// bf16).  With the products at 3xTF32 on the tensor cores (165 TFLOP/s of
// f32 work, tf32x3.cuh) the ridge is 49 flops a byte, so at the ranks these
// kernels serve the products bound them: EU at 8192 x 8192 r128 f32, 3.44e10
// flops, takes 0.208 ms against 0.080 ms of reading X.  The TPU kernels
// exist to read X once instead of twice; on this card a second read costs
// a fraction of the products' bound (0.047 ms of the f32 X at 8192 x 4096,
// at the 2.873 TB/s measured, against KL's 0.208 ms of products).
//
// EU: the wave schedule of wave.cuh.  (A) X round(H)^T; (A2) the
// elementwise W update with the denominator W Gh, formed for all rows
// before the first wave (eu_den_kernel); (B) round(W')^T X; then the Gram.
// The pass is mur_eu_waves (wave.cuh), which the sweep scripts' variants
// (mur_variants.cu) share.  mur_iteration_eu runs (A) and (B) on the tensor
// cores (wave.cuh's TcStages: 128 x 128 tiles of 3xTF32 mma.sync, one TF32
// product a step at bf16 X, every step's sum rounded to nearest, all of X
// in one wave; plan kind kWaveEuTc); the denominator W Gh and the Gram
// W'^T W' (2 m k^2 flops each, 1% of the products at r128) stay on FMA
// tiles.  The "dma" variant runs (A) and (B) on TMA and wgmma (wave.cuh's
// TmaStages, on kWaveEuTc's plan at their own fill: a ring of shared-memory
// stages that a producer fills with TMA copies while two warpgroups
// multiply, the card's counterpart of the TPU kernel's double-buffered
// strip DMA; 3xTF32 wgmma at f32 X, bf16 wgmma at bf16 X, every stage's
// sum rounded to nearest, all of X in one wave).  Its stages are those of
// the sweep scripts' v1_iter on the same operands, so at lam_w = 0 it gives
// v1_iter's bits; against mur_iteration_eu it differs by f32 summation
// order (and where that moves a bf16 rounding of W', by a bf16 ulp of a
// term of wtx).
//
// KL up to its own rank line (ops/mur_fused.py's KL_ITER_PAIR_RANK): the
// 2-pass pair's bodies, over all of X each (mur_update.cu's kl_w_lagged,
// then kl_h_numer at W'), so W' and obj are the lagged KL W pass's bit for
// bit and wtr is the KL H pass's numerator at W' bit for bit.  Each stage
// takes the pair's body for its rank: the W pass on the tensor cores up to
// kKlWTcRank (320) over column splits, the H numerator up to kKlTcRank
// (640) over row splits.  Above the line the pair's FMA bodies lose to the
// FMA waves below (8192 x 1024 on an H100, PERF.md: their blocks own whole
// rows or columns with no splits, 32 blocks of H at k 768), which split
// each L2-sized wave of rows (kl_rows_kernel: the lagged objective from
// the first W H tiles; kl_w_kernel: the closed form; kl_cols_kernel, which
// forms W' H again) over column and row chunks.  Every sum across blocks
// is partials added in a fixed order, no float atomics.
//
// Ragged edges load zeros and bound their stores; any (m, n) and k <= 1024
// work.  Built without --use_fast_math: division, sqrtf and logf stay IEEE.
#include "wave.cuh"

namespace tpunmf {

// MUR's KL passes, shared with the pair (mur_update.cu).
cudaError_t kl_w_lagged(const void* x, int x_is_bf16, const float* w, const float* h, int ldh,
                        const float* hsum, float lam, int m, int n, int k, int splits,
                        float* scratch, long long scratch_len, float* out, float* partials,
                        float* obj, cudaStream_t s);
cudaError_t kl_h_numer(const void* x, int x_is_bf16, const float* w, const float* h, int m,
                       int n, int k, int splits, float* part, long long part_len, float* numer,
                       cudaStream_t s);

namespace {

// ------------------------------------------------------------------------ EU
// mur_eu_waves (wave.cuh) on the tensor cores with H (k, n) pre-cast to X's
// type.
template <typename XT>
cudaError_t iteration_eu(const void* xv, const void* hv, const float* w, const float* gh,
                         float lam, int m, int n, int k, float* w_out, float* wtx, float* gram,
                         float* scratch, cudaStream_t s) {
  const Plan p = make_plan(m, n, k, sizeof(XT), kWaveEuTc);
  const TcStages<XT> stages{static_cast<const XT*>(xv), static_cast<const XT*>(hv), n, k};
  return mur_eu_waves(p, stages, w, gh, lam, nullptr, m, n, k, w_out, wtx, gram, scratch, s);
}

// ------------------------------------------------------------ KL, FMA waves
// Above KL_ITER_PAIR_RANK (ops/mur_fused.py): the wave schedule with
// FMA tiles, blocks owning whole rows (columns) and all of k in shared
// memory, the column (row) chunks splitting each wave to fill the card.
// (A) for the rows [row0, row0 + 16 TM) and column chunk y:
// part[y][r - r0][c] = sum_j P[r][j] H[c][j], P = X / (W H + eps), and the
// block's masked KL of (X, W H) into obj_part[blockIdx.y * gridDim.x +
// blockIdx.x]; grid (ceil(wave rows / (16 TM)), nsplit).  Dynamic shared
// memory: the (16 TM) x (kpad + 1) accumulator.
template <typename XT, int TM>
__global__ void __launch_bounds__(kThreads)
    kl_rows_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ h, int m, int n, int k, int kpad, int r0, int rows,
                   int a_cols, float* __restrict__ part, float* __restrict__ obj_part) {
  constexpr int BM = 16 * TM;
  __shared__ KlRowStage<TM> st;
  extern __shared__ float acc[];
  const int lda = kpad + 1, tid = threadIdx.x;
  const int row0 = r0 + blockIdx.x * BM;
  const int j0 = blockIdx.y * a_cols, j1 = min(j0 + a_cols, n);
  double obj = 0.0;
  for (int l = tid; l < BM * lda; l += kThreads) acc[l] = 0.f;
  kl_rows<XT, TM, true>(x, w, h, m, n, k, kpad, row0, j0, j1, acc, lda, obj, st);
  float* out = part + (long long)blockIdx.y * rows * k;
  for (int l = tid; l < BM * k; l += kThreads) {
    const int r = l / k, c = l % k, gr = row0 + r;
    if (gr < m) out[(long long)(gr - r0) * k + c] = acc[r * lda + c];
  }
  const double sum = block_sum(obj);
  if (tid == 0) obj_part[blockIdx.y * gridDim.x + blockIdx.x] = (float)sum;
}

// (A2) a = W * (the chunks' partials added in order), W' = 2a / (b +
// sqrt(b^2 + 4 lam a)) for the wave's rows [r0, r1).
__global__ void __launch_bounds__(kThreads)
    kl_w_kernel(const float* __restrict__ w, const float* __restrict__ hsum,
                const float* __restrict__ part, int nsplit, float lam, int k, int r0, int r1,
                int rows, float* __restrict__ out) {
  const long long len = (long long)(r1 - r0) * k;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < len;
       i += (long long)gridDim.x * kThreads) {
    float acc = 0.f;
    for (int z = 0; z < nsplit; ++z) acc += part[(long long)z * rows * k + i];
    const long long o = (long long)r0 * k + i;
    const float a = w[o] * acc;
    const float b = hsum[i % k];
    out[o] = 2.f * a / (b + sqrtf(b * b + 4.f * lam * a));
  }
}

// (B) the wave's rows of W'^T (X / (W' H + eps)) for the columns
// [col0, col0 + 16 TN); grid (ceil(n / (16 TN)), msplit).  msplit == 1:
// wtr = (first ? 0 : wtr) + acc; otherwise part[z] = row chunk z's acc.
// Dynamic shared memory: the kpad x (16 TN + 1) accumulator.
template <typename XT, int TN>
__global__ void __launch_bounds__(kThreads)
    kl_cols_kernel(const XT* __restrict__ x, const float* __restrict__ w_new,
                   const float* __restrict__ h, int m, int n, int k, int kpad, int r0, int r1,
                   int b_rows, bool first, float* __restrict__ wtr, float* __restrict__ part) {
  constexpr int BN = 16 * TN, ldc = BN + 1;
  __shared__ KlColStage<TN> st;
  extern __shared__ float acc[];
  const int tid = threadIdx.x, col0 = blockIdx.x * BN;
  const int i0 = r0 + blockIdx.y * b_rows, i1 = min(i0 + b_rows, r1);
  for (int l = tid; l < kpad * ldc; l += kThreads) acc[l] = 0.f;
  kl_cols<XT, TN>(x, w_new, h, m, n, k, kpad, col0, i0, i1, acc, st);
  const bool direct = gridDim.y == 1;
  float* out = direct ? wtr : part + (long long)blockIdx.y * k * n;
  for (int l = tid; l < k * BN; l += kThreads) {
    const int ck = l / BN, c = l % BN, gc = col0 + c;
    if (gc < n) {
      const long long o = (long long)ck * n + gc;
      out[o] = (direct && !first ? out[o] : 0.f) + acc[ck * ldc + c];
    }
  }
}

template <typename XT, int TM>
cudaError_t iteration_kl_tiles(const XT* x, const float* w, const float* h, const float* hsum,
                         float lam, int m, int n, int k, float* w_out, float* wtr, float* obj,
                         float* scratch, cudaStream_t s) {
  constexpr int BM = 16 * TM, TN = TM, BN = 16 * TN;
  const Plan p = make_plan(m, n, k, sizeof(XT), kWaveKl);
  const int kpad = round_up(k, kTile);
  const size_t a_smem = (size_t)BM * (kpad + 1) * sizeof(float);
  const size_t b_smem = (size_t)kpad * (BN + 1) * sizeof(float);
  float* obj_part = scratch + p.obj_part;
  int nobj = 0;
  cudaError_t err = cudaSuccess;
  for (int wave = 0; wave < p.waves && err == cudaSuccess; ++wave) {
    const int r0 = wave * p.rows, r1 = std::min(r0 + p.rows, m), rblocks = ceil_div(r1 - r0, BM);
    err = launch(kl_rows_kernel<XT, TM>, dim3(rblocks, p.nsplit), a_smem, s, x, w, h, m, n, k,
                 kpad, r0, p.rows, p.a_cols, scratch + p.a_part, obj_part + nobj);
    nobj += rblocks * p.nsplit;
    if (err != cudaSuccess) break;
    err = launch(kl_w_kernel, elementwise_grid((long long)(r1 - r0) * k), 0, s, w, hsum,
                 scratch + p.a_part, p.nsplit, lam, k, r0, r1, p.rows, w_out);
    if (err != cudaSuccess) break;
    const int msplit = ceil_div(r1 - r0, p.b_rows);
    err = launch(kl_cols_kernel<XT, TN>, dim3(ceil_div(n, BN), p.msplit), b_smem, s, x,
                 static_cast<const float*>(w_out), h, m, n, k, kpad, r0, r1, p.b_rows,
                 wave == 0, wtr, scratch + p.b_part);
    if (err == cudaSuccess && p.msplit > 1)
      err = sum_slices(wtr, scratch + p.b_part, msplit, (long long)k * n, wave > 0, s);
  }
  if (err != cudaSuccess) return err;
  return reduce_partials_into(obj_part, nobj, 1.f, obj, s);
}

template <typename XT>
cudaError_t iteration_kl(const void* xv, const float* w, const float* h, const float* hsum,
                         float lam, int m, int n, int k, float* w_out, float* wtr, float* obj,
                         float* scratch, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  return kl_block(k) == 64
             ? iteration_kl_tiles<XT, 4>(x, w, h, hsum, lam, m, n, k, w_out, wtr, obj, scratch, s)
             : iteration_kl_tiles<XT, 2>(x, w, h, hsum, lam, m, n, k, w_out, wtr, obj, scratch, s);
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// Floats of scratch the single-pass iteration of `kind` (1: MUR KL's FMA
// waves, 2: HALS EU, 3: MUR EU; 2 and 3 on the tensor cores) needs at (m,
// n, k) for X of x_bytes (4 f32, 2 bf16) an element, in 64 bits; -1 for
// another kind (the TMA stages' scratch is tpunmf_eu_tma_scratch's).
long long tpunmf_iteration_scratch(int m, int n, int k, int x_bytes, int kind) {
  using namespace tpunmf;
  if (kind < kWaveKl || kind > kWaveEuTc) return -1;
  return make_plan(m, n, k, x_bytes, kind).scratch;
}

// Floats of scratch the EU single pass on TMA and wgmma (the "dma" variant,
// v1_iter, v2_iter, iter_eu_int8) needs at (m, n, k) for X of x_bytes (4,
// 2 or 1) an element, in 64 bits: the plan's partials and den, then stage
// (B)'s factor.
long long tpunmf_eu_tma_scratch(int m, int n, int k, int x_bytes) {
  return tpunmf::tma_scratch(m, n, k, x_bytes).total;
}

// EU iteration on the tensor cores.  hc is H (k, n) in X's type, gh = H
// H^T (k, k); writes W' (m, k), wtx = round(W')^T X (k, n) and gram = W'^T
// W' (k, k); scratch of kind 3.
int tpunmf_mur_iteration_eu(const void* x, int x_is_bf16, const void* w, const void* hc,
                            const void* gh, float lam, int m, int n, int k, void* w_out,
                            void* wtx, void* gram, void* scratch, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(gh);
  float* wo = static_cast<float*>(w_out);
  float* tx = static_cast<float*>(wtx);
  float* gr = static_cast<float*>(gram);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using tpunmf::iteration_eu;
  return static_cast<int>(
      x_is_bf16 ? iteration_eu<__nv_bfloat16>(x, hc, wf, gf, lam, m, n, k, wo, tx, gr, sc, s)
                : iteration_eu<float>(x, hc, wf, gf, lam, m, n, k, wo, tx, gr, sc, s));
}

// The "dma" variant of the EU iteration, on TMA and wgmma.  H comes as the
// factor operands of wave.cuh's TmaStages, (k, n) at row stride ldh (a
// multiple of 16 bytes): f32 X: f0 its TF32 big part and f1 its small part
// (tf32x3.cuh's split), bf16 X: f0 H in bf16 (f1 unused); gh = H H^T (k,
// k).  Writes W' (m, k), wtx = round(W')^T X (k, n) and gram = W'^T W' (k,
// k).  scratch holds scratch_len floats, at least tpunmf_eu_tma_scratch's
// (fewer: cudaErrorInvalidValue).
int tpunmf_mur_iteration_eu_dma(const void* x, int x_is_bf16, const void* w, const void* f0,
                                const void* f1, int ldh, const void* gh, float lam, int m,
                                int n, int k, void* w_out, void* wtx, void* gram, void* scratch,
                                long long scratch_len, void* stream) {
  using namespace tpunmf;
  const float* wf = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(gh);
  float* wo = static_cast<float*>(w_out);
  float* tx = static_cast<float*>(wtx);
  float* gr = static_cast<float*>(gram);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_is_bf16 ? mur_eu_tma<__nv_bfloat16>(x, f0, f1, ldh, wf, gf, lam, nullptr, m, n, k, wo,
                                            tx, gr, sc, scratch_len, s)
                : mur_eu_tma<float>(x, f0, f1, ldh, wf, gf, lam, nullptr, m, n, k, wo, tx, gr,
                                    sc, scratch_len, s));
}

// KL iteration: W' (m, k), wtr = W'^T (X / (W' H + eps)) (k, n) and obj[0]
// = the masked KL of the incoming (W, H).  The lagged KL W pass (h at row
// stride ldh, hp; hsum = rowsum(H); w_splits column splits, w_part of
// w_part_len floats, partials) and then the KL H pass's numerator at W' (h
// at row stride n; h_splits row splits, h_part of h_part_len floats), as
// tpunmf_mur_w_update_lagged and tpunmf_mur_h_update take them.
int tpunmf_mur_iteration_kl(const void* x, int x_is_bf16, const void* w, const void* h,
                            const void* hp, int ldh, const void* hsum, float lam, int m, int n,
                            int k, int w_splits, void* w_part, long long w_part_len,
                            void* partials, int h_splits, void* h_part, long long h_part_len,
                            void* w_out, void* wtr, void* obj, void* stream) {
  const float* hf = static_cast<const float*>(h);
  float* wo = static_cast<float*>(w_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = tpunmf::kl_w_lagged(
      x, x_is_bf16, static_cast<const float*>(w), static_cast<const float*>(hp), ldh,
      static_cast<const float*>(hsum), lam, m, n, k, w_splits, static_cast<float*>(w_part),
      w_part_len, wo, static_cast<float*>(partials), static_cast<float*>(obj), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tpunmf::kl_h_numer(x, x_is_bf16, wo, hf, m, n, k, h_splits,
                                             static_cast<float*>(h_part), h_part_len,
                                             static_cast<float*>(wtr), s));
}

// KL iteration above KL_ITER_PAIR_RANK: the FMA waves.  hsum =
// rowsum(H) (k,); writes W' (m, k), wtr = W'^T (X / (W' H + eps)) (k, n)
// and obj[0] = the masked KL of the incoming (W, H); scratch of kind 1.
int tpunmf_mur_iteration_kl_waves(const void* x, int x_is_bf16, const void* w, const void* h,
                                  const void* hsum, float lam, int m, int n, int k,
                                  void* w_out, void* wtr, void* obj, void* scratch,
                                  void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  const float* hs = static_cast<const float*>(hsum);
  float* wo = static_cast<float*>(w_out);
  float* tr = static_cast<float*>(wtr);
  float* ob = static_cast<float*>(obj);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_is_bf16
          ? tpunmf::iteration_kl<__nv_bfloat16>(x, wf, hf, hs, lam, m, n, k, wo, tr, ob, sc, s)
          : tpunmf::iteration_kl<float>(x, wf, hf, hs, lam, m, n, k, wo, tr, ob, sc, s);
  return static_cast<int>(err);
}

}  // extern "C"
