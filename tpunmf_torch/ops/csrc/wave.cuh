// The wave schedule of the single-pass iterations: MUR's EU and, above its
// own rank line, KL (mur_iteration.cu; below it KL runs the 2-pass pair's
// bodies), the sweep scripts' EU variants (mur_variants.cu) and HALS's EU
// (hals_iteration.cu).
//
// The TPU kernels run their grid in order on one core and keep the k x n
// accumulator (wtx / wtr) resident across the row strips; on the card
// blocks run in parallel and a block has 227 KB of shared memory, so the
// rows of X are taken in waves of R rows, and for each wave, in stream
// order:
//   (A) a row kernel forms the W side over column chunks of the wave: one
//       partial per chunk, so the wave fills the card;
//   (A2) an epilogue adds the chunks' partials in a fixed order and forms W'
//       for the wave's rows (MUR: elementwise; HALS: the Gauss-Seidel sweeps);
//   (B) a column kernel adds the wave's rows into wtx / wtr.  Each output
//       element has one owner: the first wave writes, later waves add.
//       Where the wave has too few column tiles to fill the card, B splits
//       the wave's rows too, writes partials, and sum_slices adds them in
//       order.
// On FMA tiles (KL, the "dma" variant, the sweep scripts' variants) a wave is
// R * n * sizeof(X) <= kWaveBytes (24 MB, well under the 50 MB L2), so the
// wave's X is still in L2 when B reads it and X crosses device memory
// about once per iteration.  The stages on the tensor cores (TcStages
// below: mur_iteration_eu, hals_iteration_eu), whose products bind them,
// take all of X in one wave.  EU's gram = W'^T W' is formed after the last
// wave, over row chunks of W' with per-chunk partials.  Every cross-block
// sum is per-block partials added in a fixed order: no float atomics, and
// the same inputs give the same bits.
#pragma once

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "tf32x3.cuh"

namespace tpunmf {
namespace {

constexpr long long kWaveBytes = 24ll << 20;  // X bytes per wave, well under the L2
// Blocks a launch aims for: 4 per SM of the H100.  At 2 the FMA tiles of a
// short wave hide too little latency (measured slower on the card).
constexpr int kFill = 4 * 132;
// The tensor-core stages: 128 x 128 tiles, two blocks resident an SM, so
// one wave of blocks is 2 * 132; a stage splits down to at most that
// (rounding down: a few blocks past it would make a second, nearly empty
// wave).  Their partial sums are 64 KB a block.  They take all of X's rows
// in one wave: the products bind each stage, and L2-sized waves (768 rows
// of an 8192-wide f32 X) cut (A)'s blocks to 192 columns of depth and
// multiply the launches and the partial sums, while one wave reads X
// twice from device memory instead of once: on an H100 one wave was the
// faster at every shape timed, k 32 to 256 (PERF.md, tools/kernel_turns.py).
constexpr int kTcTile = 128;
constexpr int kTcFill = 2 * 132;

inline int round_up(int a, int b) { return ceil_div(a, b) * b; }

// How many pieces to split `extent` (in kTile units) into so that `blocks`
// blocks become about kFill; 1 when the launch already covers the SMs.
inline int split_for(int blocks, int extent) {
  if (blocks >= kFill / 2) return 1;
  const int s = ceil_div(kFill, blocks);
  return s < extent ? s : extent;
}

// The same for the tensor-core stages: at most kTcFill blocks.
inline int tc_split_for(int blocks, int extent) {
  const int s = kTcFill / blocks;
  return s < 1 ? 1 : (s < extent ? s : extent);
}

// Blocks of an elementwise pass over len elements (grid-stride beyond).
inline dim3 elementwise_grid(long long len) {
  const long long blocks = (len + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks < kFill ? blocks : kFill));
}

// The iteration a plan is for (the `kind` of tpunmf_iteration_scratch):
// kWaveEu the MUR EU stages on FMA tiles (the "dma" variant, the sweep
// scripts' variants), kWaveEuTc on the tensor cores (mur_iteration_eu),
// kWaveHals HALS's on the tensor cores (hals_iteration_eu: kWaveEuTc's
// layout without the den block), kWaveKl MUR KL's FMA waves
// (mur_iteration_kl above its own rank line, mur_iteration.cu).
enum Wave { kWaveEu = 0, kWaveKl = 1, kWaveHals = 2, kWaveEuTc = 3 };

struct Plan {
  int rows, waves;             // R rows of X per wave (a multiple of kTile)
  int a_cols, nsplit;          // (A): column chunk width, chunks
  int b_rows, msplit;          // (B): row chunk height, chunks
  int g_rows, gsplit;          // EU gram: row chunk height, chunks
  long long a_part, b_part, g_part, obj_part, den, scratch;  // float offsets, total
};

inline Plan make_plan(int m, int n, int k, int x_bytes, int kind) {
  const bool kl = kind == kWaveKl, tc = kind == kWaveEuTc || kind == kWaveHals;
  Plan p{};
  // a wave is whole row tiles of its stages; the tensor-core stages take
  // all of X in one (see kTcTile)
  const int wave_tile = tc ? kTcTile : kTile;
  long long rows = kWaveBytes / ((long long)n * x_bytes) / wave_tile * wave_tile;
  const int all = round_up(m, wave_tile);
  p.rows = tc || rows > all ? all : (rows < wave_tile ? wave_tile : (int)rows);
  p.waves = ceil_div(m, p.rows);
  const int ktiles = ceil_div(k, kTile);

  // KL blocks own whole rows (columns) and all of k; EU blocks 64 x 64
  // tiles, or 128 x 128 on the tensor cores
  const int tile = kl ? kl_block(k) : tc ? kTcTile : kTile;
  const int tiles_k = kl ? 1 : ceil_div(k, tile);
  auto split = tc ? tc_split_for : split_for;
  const int a_blocks = ceil_div(p.rows, tile) * tiles_k;
  p.a_cols = round_up(ceil_div(n, split(a_blocks, ceil_div(n, kTile))), kTile);
  p.nsplit = ceil_div(n, p.a_cols);

  const int b_blocks = ceil_div(n, tile) * tiles_k;
  p.b_rows = round_up(ceil_div(p.rows, split(b_blocks, p.rows / kTile)), kTile);
  p.msplit = ceil_div(p.rows, p.b_rows);

  p.g_rows = round_up(ceil_div(m, split_for(ktiles * ktiles, ceil_div(m, kTile))), kTile);
  p.gsplit = kl ? 0 : ceil_div(m, p.g_rows);

  // float offsets in 64 bits: one wave's partials pass INT_MAX floats near
  // nsplit * m * k = 2^31 (a tall X at k 256)
  p.a_part = 0;
  p.b_part = p.a_part + (long long)p.nsplit * p.rows * k;
  p.g_part = p.b_part + (p.msplit > 1 ? (long long)p.msplit * k * n : 0);
  p.obj_part = p.g_part + (long long)p.gsplit * k * k;
  p.den = p.obj_part + (kl ? (long long)p.waves * ceil_div(p.rows, tile) * p.nsplit : 0);
  p.scratch = p.den + (kind == kWaveEu || kind == kWaveEuTc ? (long long)m * k : 0);
  return p;
}

// out[i] = (add ? out[i] : 0) + parts[0][i] + parts[1][i] + ..., in that order.
__global__ void __launch_bounds__(kThreads)
    sum_slices_kernel(float* __restrict__ out, const float* __restrict__ parts, int count,
                      long long len, bool add) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < len;
       i += (long long)gridDim.x * kThreads) {
    float v = add ? out[i] : 0.f;
    for (int s = 0; s < count; ++s) v += parts[s * len + i];
    out[i] = v;
  }
}

inline cudaError_t sum_slices(float* out, const float* parts, int count, long long len,
                              bool add, cudaStream_t s) {
  return launch(sum_slices_kernel, elementwise_grid(len), 0, s, out, parts, count, len, add);
}

// ----------------------------------------------------- the EU wave kernels
// ASYNC: the tile loops with two-stage cp.async copies (common.cuh), the
// same FMAs in the same order.

// (A) part[z][r - r0][c] = sum over the columns of chunk z of X[r] round(H[c]);
// grid (ceil(wave rows / 64), ceil(k / 64), nsplit).  f is H (k, n) of type
// FT, or with NK H^T (n, k), taken by factor_as_x; the two-stage loops take
// H (k, n) in X's type only.  `aligned`: the rows of X and f start on 16 bytes.
template <typename XT, typename FT, bool NK, bool ASYNC>
__global__ void __launch_bounds__(kThreads)
    eu_rows_kernel(const XT* __restrict__ x, const FT* __restrict__ f, int m, int n, int k,
                   int r0, int rows, int a_cols, bool aligned, float* __restrict__ part) {
  static_assert(!ASYNC || (std::is_same_v<FT, XT> && !NK), "cp.async stages H (k, n) as X");
  __shared__ std::conditional_t<ASYNC, XftStage<XT>, EuStage> st;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = r0 + blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int j0 = blockIdx.z * a_cols, j1 = min(j0 + a_cols, n);
  float numer[4][4];
  zero(numer);
  if constexpr (ASYNC)
    x_ft_tile_async<XT>(numer, x, f, m, n, k, row0, c0, j0, j1, aligned, st);
  else
    x_ft_tile<XT, FT, NK>(numer, x, f, m, n, k, row0, c0, j0, j1, st);
  float* out = part + (long long)blockIdx.z * rows * k;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gr = row0 + ty + 16 * a, gc = c0 + tx + 16 * b;
      if (gr < m && gc < k) out[(long long)(gr - r0) * k + gc] = numer[a][b];
    }
}

// (B) the wave's rows of round(W')^T X into wtx; grid (ceil(n / 64),
// ceil(k / 64), msplit).  msplit == 1: wtx = (first ? 0 : wtx) + tile;
// otherwise part[z] = the tile of row chunk z.  x_aligned / w_aligned: the
// rows of X / W' start on 16 bytes.
template <typename XT, bool ASYNC>
__global__ void __launch_bounds__(kThreads)
    eu_cols_kernel(const XT* __restrict__ x, const float* __restrict__ w_new, int n, int k,
                   int r0, int r1, int b_rows, bool first, bool x_aligned, bool w_aligned,
                   float* __restrict__ wtx, float* __restrict__ part) {
  __shared__ std::conditional_t<ASYNC, FtxStage<XT>, EuStage> st;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int i0 = r0 + blockIdx.z * b_rows, i1 = min(i0 + b_rows, r1);
  float acc[4][4];
  zero(acc);
  if constexpr (ASYNC)
    ft_x_tile_async<XT>(acc, x, w_new, n, k, col0, c0, i0, i1, x_aligned, w_aligned, st);
  else
    ft_x_tile<XT>(acc, x, w_new, n, k, col0, c0, i0, i1, st);
  const bool direct = gridDim.z == 1;
  float* out = direct ? wtx : part + (long long)blockIdx.z * k * n;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gr = c0 + ty + 16 * a, gj = col0 + tx + 16 * b;
      if (gr < k && gj < n) {
        const long long o = (long long)gr * n + gj;
        out[o] = (direct && !first ? out[o] : 0.f) + acc[a][b];
      }
    }
}

// gram partial of row chunk z: part[z] = W'[chunk]^T W'[chunk];
// grid (ceil(k / 64), ceil(k / 64), gsplit).
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const float* __restrict__ w, int m, int k, int g_rows,
                float* __restrict__ part) {
  __shared__ EuStage st;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int i0 = blockIdx.z * g_rows, i1 = min(i0 + g_rows, m);
  float acc[4][4];
  zero(acc);
  ft_x_tile<float>(acc, w, w, k, k, col0, c0, i0, i1, st);
  float* out = part + (long long)blockIdx.z * k * k;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gr = c0 + ty + 16 * a, gc = col0 + tx + 16 * b;
      if (gr < k && gc < k) out[(long long)gr * k + gc] = acc[a][b];
    }
}

// ------------------------------------------ the EU stages on the tensor cores
// (A) and (B) again, as 128 x 128 tiles of 3xTF32 mma.sync (tf32x3.cuh:
// tile_mma, both operands by two-stage 16-byte cp.async), for
// mur_iteration_eu.  f32 X splits both operands; at bf16 X both operands
// are bf16 values (X, the wrapper's pre-cast H, and W' rounded to bf16 as
// its tile lands in (B)), exact in TF32, so one TF32 product a step gives
// the same products.  What they compute is what the FMA stages compute; the
// sums come in another order.

// Both operands bf16 values: one TF32 product a step (tf32x3.cuh, EXACT).
template <typename XT>
constexpr bool kExact = std::is_same_v<XT, __nv_bfloat16>;
// Both stages round every 8-deep step's sum to nearest (tf32x3.cuh,
// ROUNDED): the tensor cores truncate what they accumulate, so their sums
// come out short, all one way, by a share that grows with the depth
// (thousands of steps in one wave).  Each output suffers from that:
// wtx, and the 2-pass H pass's numerator, feed the Gram objective 0.5
// (||X||^2 - 2 <wtx, H> + <W^T W, H H^T>), which cancels near convergence
// (tests/test_torch_cuda.py, the Gram objective near convergence); W' and
// its Gram drifted by 4.7e-5 from FMA tiles' at 8192 x 8192 r128 f32 with
// (A)'s own sums; and at bf16 X W' is rounded to bf16 for (B), where short
// sums move those roundings one way (wtx 1.08e-4 off the plain version at
// 300 x 50001 r512 in tests/test_torch_cuda.py).
constexpr bool kRounded = true;

// (A): X's rows against H's rows (k, n) in X's type; (B): W' read down its
// columns against X depth-major.  Warps 2 x 4, 64 x 32 each.
template <typename XT>
using RowsTile = tc::Tile<kTcTile, kTcTile, 2, 4, XT, XT, false, true>;
template <typename XT>
using ColsTile = tc::Tile<kTcTile, kTcTile, 2, 4, float, XT, true, false>;

// (A) part[z][r - r0][c] = sum over the columns of chunk z of X[r] Hc[c],
// for the wave's rows [r0, r1); grid (ceil((r1 - r0) / 128), ceil(k / 128),
// nsplit); `rows` is the partials' row count.  `aligned`: the rows of X and
// Hc start on 16 bytes.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    eu_rows_tc_kernel(const XT* __restrict__ x, const XT* __restrict__ hc, int n, int k,
                      int r0, int r1, int rows, int a_cols, bool aligned,
                      float* __restrict__ part) {
  using T = RowsTile<XT>;
  extern __shared__ float4 smem_raw[];
  auto& st = *reinterpret_cast<typename T::Stage*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = r0 + blockIdx.x * kTcTile, c0 = blockIdx.y * kTcTile;
  const int j0 = blockIdx.z * a_cols, j1 = min(j0 + a_cols, n);
  tc::Acc<T::MT, T::NT> acc;
  tc::zero(acc);
  tc::tile_mma<T, kExact<XT>, kRounded>(acc, x + (long long)row0 * n + j0, n, r1 - row0,
                                        hc + (long long)c0 * n + j0, n, k - c0, j1 - j0,
                                        aligned, aligned, st);
  float* out = part + (long long)blockIdx.z * rows * k;
  tc::for_pairs<T::MT, T::NT>(acc, T::warp_row(warp), T::warp_col(warp), lane,
                              [&](int r, int c, float v0, float v1) {
                                const int gr = row0 + r, gc = c0 + c;
                                if (gr >= r1) return;
                                float* o = out + (long long)(gr - r0) * k + gc;
                                if (gc < k) o[0] = v0;
                                if (gc + 1 < k) o[1] = v1;
                              });
}

// (B) round(W')^T X over the rows [r0, r1) of X into wtx (k, n); grid
// (ceil(n / 128), ceil(k / 128), msplit), block z over the rows [r0 + z
// b_rows, ...) clipped to r1.  msplit == 1: wtx = (first ? 0 : wtx) + tile;
// otherwise part[z] = the tile of row chunk z.  x_aligned / w_aligned: the
// rows of X / W' start on 16 bytes.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    eu_cols_tc_kernel(const XT* __restrict__ x, const float* __restrict__ w_new, int n, int k,
                      int r0, int r1, int b_rows, bool first, bool x_aligned, bool w_aligned,
                      float* __restrict__ wtx, float* __restrict__ part) {
  using T = ColsTile<XT>;
  extern __shared__ float4 smem_raw[];
  auto& st = *reinterpret_cast<typename T::Stage*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kTcTile, c0 = blockIdx.y * kTcTile;
  const int i0 = r0 + blockIdx.z * b_rows, i1 = min(i0 + b_rows, r1);
  tc::Acc<T::MT, T::NT> acc;
  tc::zero(acc);
  tc::tile_mma<T, kExact<XT>, kRounded, XT>(acc, w_new + (long long)i0 * k + c0, k, k - c0,
                                            x + (long long)i0 * n + col0, n, n - col0, i1 - i0,
                                            w_aligned, x_aligned, st);
  const bool direct = gridDim.z == 1;
  float* out = direct ? wtx : part + (long long)blockIdx.z * k * n;
  tc::for_pairs<T::MT, T::NT>(acc, T::warp_row(warp), T::warp_col(warp), lane,
                              [&](int r, int c, float v0, float v1) {
                                const int gr = c0 + r, gj = col0 + c;
                                if (gr >= k) return;
                                float* o = out + (long long)gr * n + gj;
                                if (gj < n) o[0] = (direct && !first ? o[0] : 0.f) + v0;
                                if (gj + 1 < n) o[1] = (direct && !first ? o[1] : 0.f) + v1;
                              });
}

// One launch of (B) on the tensor cores over `splits` row chunks of b_rows.
template <typename XT>
cudaError_t tc_cols(const XT* x, const float* w_new, int n, int k, int r0, int r1, int b_rows,
                    int splits, bool first, float* wtx, float* part, cudaStream_t s) {
  constexpr int V = 16 / sizeof(XT);
  return launch(eu_cols_tc_kernel<XT>, dim3(ceil_div(n, kTcTile), ceil_div(k, kTcTile), splits),
                sizeof(typename ColsTile<XT>::Stage), s, x, w_new, n, k, r0, r1, b_rows, first,
                n % V == 0 && aligned16(x), k % 4 == 0 && aligned16(w_new), wtx, part);
}

// --------------------------------------------------------- the EU waves
// The pair of stage kernels a wave runs, (A) into part and (B) into wtx
// (or part), and the plan kind that sizes them: FMA tiles (the "dma"
// variant with ASYNC, the sweep scripts' variants) ...
template <typename XT, typename FT, bool NK, bool ASYNC>
struct FmaStages {
  static constexpr int kKind = kWaveEu;
  static cudaError_t rows(const Plan& p, const XT* x, const FT* f, int m, int n, int k, int r0,
                          int r1, bool aligned, float* part, cudaStream_t s) {
    return launch(eu_rows_kernel<XT, FT, NK, ASYNC>,
                  dim3(ceil_div(r1 - r0, kTile), ceil_div(k, kTile), p.nsplit), 0, s, x, f, m,
                  n, k, r0, p.rows, p.a_cols, aligned, part);
  }
  static cudaError_t cols(const Plan& p, const XT* x, const float* w_new, int n, int k, int r0,
                          int r1, bool first, float* wtx, float* part, cudaStream_t s) {
    constexpr int V = 16 / sizeof(XT);
    return launch(eu_cols_kernel<XT, ASYNC>,
                  dim3(ceil_div(n, kTile), ceil_div(k, kTile), p.msplit), 0, s, x, w_new, n, k,
                  r0, r1, p.b_rows, first, n % V == 0 && aligned16(x),
                  k % 4 == 0 && aligned16(w_new), wtx, part);
  }
};

// ... or the tensor cores (mur_iteration_eu, and hals_iteration_eu on its
// own plan kind; H in X's type).
template <typename XT>
struct TcStages {
  static constexpr int kKind = kWaveEuTc;
  static cudaError_t rows(const Plan& p, const XT* x, const XT* f, int m, int n, int k, int r0,
                          int r1, bool aligned, float* part, cudaStream_t s) {
    return launch(eu_rows_tc_kernel<XT>,
                  dim3(ceil_div(r1 - r0, kTcTile), ceil_div(k, kTcTile), p.nsplit),
                  sizeof(typename RowsTile<XT>::Stage), s, x, f, n, k, r0, r1, p.rows,
                  p.a_cols, aligned, part);
  }
  static cudaError_t cols(const Plan& p, const XT* x, const float* w_new, int n, int k, int r0,
                          int r1, bool first, float* wtx, float* part, cudaStream_t s) {
    return tc_cols(x, w_new, n, k, r0, r1, p.b_rows, p.msplit, first, wtx, part, s);
  }
};

// The EU waves: per wave (A), epilogue(r0, r1) (which writes W' for the
// wave's rows [r0, r1) into w_out from the partials at scratch + p.a_part),
// (B); then gram = W'^T W'.  f is H as Stages::rows takes it; p was made
// for Stages::kKind (or kWaveHals, on the tensor cores' stages).
template <typename XT, typename FT, bool NK, bool ASYNC,
          class Stages = FmaStages<XT, FT, NK, ASYNC>, typename Epilogue>
cudaError_t eu_waves(const Plan& p, const XT* x, const FT* f, int m, int n, int k,
                     Epilogue epilogue, float* w_out, float* wtx, float* gram, float* scratch,
                     cudaStream_t s) {
  constexpr int V = 16 / sizeof(XT);
  const bool h_aligned = n % V == 0 && aligned16(x) && aligned16(f);
  const int ktiles = ceil_div(k, kTile);
  cudaError_t err = cudaSuccess;
  for (int wave = 0; wave < p.waves && err == cudaSuccess; ++wave) {
    const int r0 = wave * p.rows, r1 = std::min(r0 + p.rows, m);
    err = Stages::rows(p, x, f, m, n, k, r0, r1, h_aligned, scratch + p.a_part, s);
    if (err != cudaSuccess) break;
    err = epilogue(r0, r1);
    if (err != cudaSuccess) break;
    const int msplit = ceil_div(r1 - r0, p.b_rows);
    err = Stages::cols(p, x, w_out, n, k, r0, r1, wave == 0, wtx, scratch + p.b_part, s);
    if (err == cudaSuccess && p.msplit > 1)
      err = sum_slices(wtx, scratch + p.b_part, msplit, (long long)k * n, wave > 0, s);
  }
  if (err != cudaSuccess) return err;
  err = launch(gram_kernel, dim3(ktiles, ktiles, p.gsplit), 0, s,
               static_cast<const float*>(w_out), m, k, p.g_rows, scratch + p.g_part);
  if (err != cudaSuccess) return err;
  return sum_slices(gram, scratch + p.g_part, p.gsplit, (long long)k * k, false, s);
}

// ------------------------------------------------ the MUR EU single pass
// Shared by mur_iteration.cu (mur_iteration_eu and its dma variant) and
// mur_variants.cu (the sweep scripts' v1_iter, v2_iter and iter_eu_int8).

// den = W Gh for all rows, before the first wave; grid (ceil(m / 64), ceil(k / 64)).
__global__ void __launch_bounds__(kThreads)
    eu_den_kernel(const float* __restrict__ w, const float* __restrict__ gh, int m, int k,
                  float* __restrict__ den) {
  __shared__ EuStage st;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  float acc[4][4];
  zero(acc);
  w_g_tile(acc, w, gh, m, k, row0, c0, st);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gr = row0 + ty + 16 * a, gc = c0 + tx + 16 * b;
      if (gr < m && gc < k) den[(long long)gr * k + gc] = acc[a][b];
    }
}

// (A2) W' = W * numer / (den + lam W + eps) for the wave's rows [r0, r1),
// numer the chunks' partials added in order, times *scale where scale is
// not null (int8 X's dequantisation, benchmarks/sweep_int8.py:38-39).
__global__ void __launch_bounds__(kThreads)
    eu_w_kernel(const float* __restrict__ w, const float* __restrict__ den,
                const float* __restrict__ part, int nsplit, float lam,
                const float* __restrict__ scale, int k, int r0, int r1, int rows,
                float* __restrict__ out) {
  const long long len = (long long)(r1 - r0) * k;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < len;
       i += (long long)gridDim.x * kThreads) {
    float numer = 0.f;
    for (int z = 0; z < nsplit; ++z) numer += part[(long long)z * rows * k + i];
    if (scale != nullptr) numer *= *scale;
    const long long o = (long long)r0 * k + i;
    const float wv = w[o];
    out[o] = wv * numer / (den[o] + lam * wv + kEps);
  }
}

// The MUR EU single pass: den = W Gh, then the EU waves with the W update
// as epilogue.  f is H as Stages::rows takes it (FT, NK).
template <typename XT, typename FT, bool NK, bool ASYNC,
          class Stages = FmaStages<XT, FT, NK, ASYNC>>
cudaError_t mur_eu_waves(const XT* x, const FT* f, const float* w, const float* gh, float lam,
                         const float* scale, int m, int n, int k, float* w_out, float* wtx,
                         float* gram, float* scratch, cudaStream_t s) {
  const Plan p = make_plan(m, n, k, sizeof(XT), Stages::kKind);
  const float* den = scratch + p.den;
  const float* part = scratch + p.a_part;
  cudaError_t err = launch(eu_den_kernel, dim3(ceil_div(m, kTile), ceil_div(k, kTile)), 0, s, w,
                           gh, m, k, scratch + p.den);
  if (err != cudaSuccess) return err;
  auto w_update = [&](int r0, int r1) {
    return launch(eu_w_kernel, elementwise_grid((long long)(r1 - r0) * k), 0, s, w, den, part,
                  p.nsplit, lam, scale, k, r0, r1, p.rows, w_out);
  };
  return eu_waves<XT, FT, NK, ASYNC, Stages>(p, x, f, m, n, k, w_update, w_out, wtx, gram,
                                            scratch, s);
}

}  // namespace
}  // namespace tpunmf
