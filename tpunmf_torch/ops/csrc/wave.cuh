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
// Two kinds of stages run EU's (A) and (B), each with its plan kind (Wave):
//   - TcStages, 3xTF32 mma.sync on the tensor cores (tf32x3.cuh):
//     mur_iteration_eu and hals_iteration_eu;
//   - TmaStages, wgmma fed by TMA copies (hopper.cuh): the "dma" variant of
//     mur_iteration_eu and the sweep scripts' v1_iter, v2_iter and
//     iter_eu_int8.
// Both, whose products bind them, take all of X in one wave; MUR KL's FMA
// waves (mur_iteration.cu) take R * n * sizeof(X) <= kWaveBytes (24 MB,
// well under the 50 MB L2), so the wave's X is still in L2 when (B) reads
// it and X crosses device memory about once per iteration.  EU's gram =
// W'^T W' is formed after the last wave, over row chunks of W' with
// per-chunk partials.  Every cross-block sum is per-block partials added in
// a fixed order: no float atomics, and the same inputs give the same bits.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"
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
// TmaStages: 128 x 128 tiles too, one block an SM (192 KB of shared
// memory), so a stage splits down to at most 132 blocks.  They too take
// all of X in one wave: L2-sized waves were 1.2-3.1x slower on an H100 at
// every shape timed (PERF.md).
constexpr int kTmaFill = 132;

inline int round_up(int a, int b) { return ceil_div(a, b) * b; }

// How many pieces to split `extent` (in kTile units) into so that `blocks`
// blocks become about kFill; 1 when the launch already covers the SMs.
inline int split_for(int blocks, int extent) {
  if (blocks >= kFill / 2) return 1;
  const int s = ceil_div(kFill, blocks);
  return s < extent ? s : extent;
}

// The same for the tensor-core stages: at most `fill` blocks.
inline int tc_split_for(int blocks, int extent, int fill = kTcFill) {
  const int s = fill / blocks;
  return s < 1 ? 1 : (s < extent ? s : extent);
}

// Blocks of an elementwise pass over len elements (grid-stride beyond).
inline dim3 elementwise_grid(long long len) {
  const long long blocks = (len + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks < kFill ? blocks : kFill));
}

// The iteration a plan is for (the `kind` of tpunmf_iteration_scratch, 1-3):
// kWaveEuTc the MUR EU stages on the tensor cores (mur_iteration_eu),
// kWaveHals HALS's (hals_iteration_eu: kWaveEuTc's layout without the den
// block), kWaveKl MUR KL's FMA waves (mur_iteration_kl above its own rank
// line, mur_iteration.cu).  TmaStages (the "dma" variant, v1_iter,
// v2_iter, iter_eu_int8) take kWaveEuTc's plan at their own fill,
// kTmaFill, and their scratch from tpunmf_eu_tma_scratch, which adds stage
// (B)'s factor operand.  (Kind 0, the EU stages on FMA tiles, is gone; the
// others keep their numbers, which the wrappers pass.)
enum Wave { kWaveKl = 1, kWaveHals = 2, kWaveEuTc = 3 };

struct Plan {
  int rows, waves;             // R rows of X per wave (a multiple of kTile)
  int a_cols, nsplit;          // (A): column chunk width, chunks
  int b_rows, msplit;          // (B): row chunk height, chunks
  int g_rows, gsplit;          // EU gram: row chunk height, chunks
  long long a_part, b_part, g_part, obj_part, den, scratch;  // float offsets, total
};

// tc_fill: the blocks a stage on the tensor cores splits down to.
inline Plan make_plan(int m, int n, int k, int x_bytes, int kind, int tc_fill = kTcFill) {
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
  auto split = [&](int blocks, int extent) {
    return tc ? tc_split_for(blocks, extent, tc_fill) : split_for(blocks, extent);
  };
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
  p.scratch = p.den + (kind == kWaveEuTc ? (long long)m * k : 0);
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

// ------------------------------------------------------------ the Gram
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

// ------------------------------------------- the EU stages on TMA and wgmma
// (A) and (B) as 128 x 128 tiles of wgmma products fed by TMA, for the
// "dma" variant of mur_iteration_eu and the sweep scripts' v1_iter,
// v2_iter and iter_eu_int8 (the TPU kernels overlap the copies of X's
// strips with the products by hand, tpunmf/ops/mur_fused.py:368-437; on
// this card that is the Tensor Memory Accelerator's job).  A block is two
// consumer warpgroups, each 64 rows of the output tile, and a producer
// warpgroup, one thread of which keeps a ring of STAGES shared-memory
// stages filled: a stage is the X tile and the factor tile(s) of KC depth
// (one 128-byte swizzled factor row), a full and an empty mbarrier each.
// The producer gives its registers to the consumers (setmaxnreg: 56 and 224
// a thread; at the 168 a thread that fit every warp, ptxas spilled at f32).
//
// TF32 operands of wgmma in shared memory must be K-major, and neither
// stage has both operands contiguous along the depth ((B)'s depth runs
// down X's and W's columns).  So X is wgmma's A operand from registers in
// both stages, read from its swizzled tile in the fragment layout ((A) along
// X's rows, (B) down its columns, so that (B) forms wtx^T tiles), and the
// factor is the B operand from shared memory, K-major: (A) H (k, n) as the
// wrapper prepared it, (B) W'^T (k, m), written by wt_operand_kernel after
// the W update.  f32 X: 3xTF32 (tf32x3.cuh: the integer split, and the
// small*big, big*small, big*big passes in that order), X split in
// registers, the factor split in device memory (H by the wrapper, W'^T by
// wt_operand_kernel, with tc::split's rule); bf16 X: one bf16 wgmma, W'
// rounded to bf16 by wt_operand_kernel as the FMA and mma.sync stages
// round it; int8 X (iter_eu_int8, benchmarks/sweep_int8.py:27-46): bf16's
// products, X widened to bf16 exactly in registers as the consumers build
// its fragments (hop::bf16x2_of_s8x2), against the bf16 factors; a stage
// stays 64 deep (the factor's 128-byte row), so X's (A) tile has 64-byte
// rows (TMA's 64-byte swizzle) and its (B) tile one 128-column box.  The
// tensor cores truncate what they accumulate, so each stage's products go
// into a temporary (its first wgmma with scale-d = 0), added to the
// block's running sum in f32 with round to nearest once they have landed:
// a rounded step of KC depth (32 at f32, 64 at bf16 and int8), where
// TcStages rounds every 8-deep step.  A warpgroup waits for its stage's
// products before that add; the other warpgroup's products keep the
// tensor cores busy meanwhile.  int8 X and bf16 X of the same values give
// the same products, stages and sums: the same bits.
//
// X's rows on 16 bytes (its base, and n * sizeof(X) a multiple of 16) go
// by TMA; otherwise TMA cannot describe X, and the producer warpgroup
// copies each row of its tile as the 16-byte chunks that cover it
// (hop::copy_rows: cp.async, each thread's landing counted on the stage's
// full barrier; zeros past X's edges and the depth chunk's), a row's first
// element some 0-15 bytes into it, and the consumers read there
// (hop::shifted_at).  TMA fills reads past the arrays' edges with zeros;
// every chunk of depth starts and ends on a stage, but at X's own edge.

constexpr int kTmaThreads = 3 * 128;  // two consumer warpgroups, one producer warpgroup

// TMA = false: X's tiles by hop::copy_rows, in a larger X tile.
template <typename XT, bool TMA = true>
struct TmaTile {
  static constexpr bool kF32 = std::is_same_v<XT, float>;
  static constexpr bool kInt8 = std::is_same_v<XT, int8_t>;
  using FT = std::conditional_t<kInt8, __nv_bfloat16, XT>;  // the factors' type
  static constexpr int ES = sizeof(XT);
  static constexpr int BM = kTcTile, BN = kTcTile;  // output rows, columns of k
  static constexpr int KC = 128 / sizeof(FT);       // depth of a stage
  static constexpr int XROW = KC * ES;              // bytes of an (A) X tile's row
  static constexpr int STEPS = 4;                   // wgmmas of 32 bytes of factor depth a stage
  static constexpr int TILE = BN * 128;             // bytes of a factor tile
  static constexpr int XBYTES = BM * XROW;          // bytes of TMA's boxes of an X tile
  static constexpr int XC = 128 / ES;    // X's columns in one of (B)'s boxes
  static constexpr int XBOX = KC * 128;  // bytes of one of (B)'s X boxes (KC x XC)
  // X's rows off 16 bytes (hop::copy_rows): the chunks covering an (A)
  // row of KC elements and a (B) row of BM, and the bytes each row takes
  // ((B) f32: 544, so that the 4 rows of a fragment load sit 8 banks apart)
  static constexpr int NCHA = XROW / 16 + 1, RA = NCHA * 16;
  static constexpr int NCHB = BM * ES / 16 + 1, RB = kF32 ? 544 : NCHB * 16;
  static constexpr int XTILE =  // bytes of an X tile, on 1024 bytes
      TMA ? XBYTES : (std::max(BM * RA, KC * RB) + 1023) / 1024 * 1024;
  static constexpr int FACTORS = kF32 ? 2 : 1;      // factor tiles: big and small, or bf16
  static constexpr int STAGE = XTILE + TILE * FACTORS;
  static constexpr int STAGES = kF32 ? 4 : kInt8 ? 8 : 6;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// Byte offsets of X's elements in a stage's swizzled X tile: (A) element
// (r, d) of 128 rows by KC of depth; (B) element (d, j) of KC depth rows
// by 128 columns, in BM / XC boxes of XC columns.
template <typename XT>
__device__ __forceinline__ int x_rows_at(int r, int d) {
  return hop::swizzled<TmaTile<XT>::XROW>(r, d * (int)sizeof(XT));
}
template <typename XT>
__device__ __forceinline__ int x_cols_at(int d, int j) {
  return hop::cols_at<sizeof(XT), TmaTile<XT>::KC>(d, j);
}

// COLS = false, (A): part[z][r - r0][c] = sum over the columns [z chunk,
// (z + 1) chunk) of X[r] F[c], F the factor (k, n) of maps f0 (f32: TF32
// big part) and f1 (small part); grid (ceil((r1 - r0) / 128), ceil(k /
// 128), nsplit), `rows` the partials' row count.  COLS = true, (B): the
// rows [r0 + z chunk, ...) clipped to r1 of F^T X, F = W' (m, k) given
// transposed by f0 / f1 (k, m); grid (ceil(n / 128), ceil(k / 128),
// msplit); gridDim.z == 1: out (wtx) = (first ? 0 : out) + tile, else
// out[z] = the tile (partials).  TMA: the producer loads X's tiles through
// xmap (X in the stage's boxes), else copies their rows from x; two
// kernels, so that TMA's consumers carry none of the copies' addressing
// (one kernel choosing at run time was 4-14% slower on TMA's tiles on an
// H100 80GB HBM3 at 700 W).
template <typename XT, bool COLS, bool TMA>
__global__ void __launch_bounds__(kTmaThreads, 1)
    eu_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap f0, const __grid_constant__ CUtensorMap f1,
                  const XT* __restrict__ x, int m, int n, int k, int r0, int r1, int rows,
                  int chunk, bool first, float* __restrict__ out) {
  using T = TmaTile<XT, TMA>;
  extern __shared__ float4 smem_raw[];  // the declaration of the TC kernels
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the output tile's first row (X's rows in (A), its columns in (B)),
  // first column of k, and the depth [d0, d1)
  const int o0 = (COLS ? 0 : r0) + blockIdx.x * T::BM, c0 = blockIdx.y * T::BN;
  const int d0 = (COLS ? r0 : 0) + blockIdx.z * chunk;
  const int d1 = min(d0 + chunk, COLS ? r1 : n);
  const int nst = d1 > d0 ? (d1 - d0 + T::KC - 1) / T::KC : 0;
  constexpr bool tma = TMA;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hop::mbar_init(&full[s], tma ? 1 : 129);  // else: and each producer thread
      hop::mbar_init(&empty[s], 256);              // every consumer thread
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // ------------------------------------------- producer
    hop::setmaxnreg_dec<56>();
    const int p = threadIdx.x - 256;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % T::STAGES;
      uint8_t* st = smem + slot * T::STAGE;
      const int d = d0 + s * T::KC;
      if (p == 0 || !tma) hop::mbar_wait(&empty[slot], ((s / T::STAGES) & 1) ^ 1);
      if (p == 0) {
        hop::mbar_arrive_expect_tx(&full[slot], T::TILE * T::FACTORS + (tma ? T::XBYTES : 0));
        hop::tma_load(st + T::XTILE, &f0, &full[slot], d, c0);
        if constexpr (T::kF32) hop::tma_load(st + T::XTILE + T::TILE, &f1, &full[slot], d, c0);
        if (tma) {
          if constexpr (COLS) {
#pragma unroll
            for (int q = 0; q < T::BM / T::XC; ++q)
              hop::tma_load(st + q * T::XBOX, &xmap, &full[slot], o0 + q * T::XC, d);
          } else {
            hop::tma_load(st, &xmap, &full[slot], d, o0);
          }
        }
      }
      if (!tma) {
        // (A): rows of X by depth columns; (B): depth rows by X's columns
        if constexpr (COLS)
          hop::copy_rows<T::ES, T::KC, T::NCHB, T::RB>(st, x, n, d, d1, o0, n, p, &full[slot]);
        else
          hop::copy_rows<T::ES, T::BM, T::NCHA, T::RA>(st, x, n, o0, m, d, d1, p, &full[slot]);
      }
    }
  } else {  // ---------------------------------------------------- consumers
    hop::setmaxnreg_inc<224>();
    const int g = lane >> 2, t = lane & 3;
    const int row = 64 * (warp >> 2) + 16 * (warp & 3) + g;  // the thread's first fragment row
    // X's rows off 16 bytes: element (i, j) lies at xb + (i n + j) ES
    const uint32_t xb = (uint32_t)reinterpret_cast<uintptr_t>(x), row_bytes = (uint32_t)n * T::ES;
    float acc[64], tmp[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % T::STAGES, ds = d0 + s * T::KC;
      hop::mbar_wait(&full[slot], (s / T::STAGES) & 1);
      const uint8_t* st = smem + slot * T::STAGE;
      // byte offset of X's element (A) (r, d) / (B) (d, j) of the stage
      auto xat = [&](int a, int b) {
        if constexpr (TMA)
          return COLS ? x_cols_at<XT>(a, b) : x_rows_at<XT>(a, b);
        else if constexpr (COLS)
          return hop::shifted_at<T::ES, T::RB>(
              a, xb + (uint32_t)(ds + a) * row_bytes + (uint32_t)o0 * T::ES, b);
        else
          return hop::shifted_at<T::ES, T::RA>(
              a, xb + (uint32_t)(o0 + a) * row_bytes + (uint32_t)ds * T::ES, b);
      };
      const uint64_t big = hop::desc_sw128(st + T::XTILE);
      if constexpr (T::kF32) {
        const uint64_t small = hop::desc_sw128(st + T::XTILE + T::TILE);
        uint32_t ab[T::STEPS][4], as[T::STEPS][4];
#pragma unroll
        for (int q = 0; q < T::STEPS; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
            const int r = row + 8 * (e & 1), d = 8 * q + t + 4 * (e >> 1);
            const float v = *reinterpret_cast<const float*>(
                st + (TMA ? (COLS ? x_cols_at<XT>(d, r) : x_rows_at<XT>(r, d))
                          : (COLS ? xat(d, r) : xat(r, d))));
            tc::split(v, ab[q][e], as[q][e]);
          }
        hop::wgmma_fence();
#pragma unroll
        for (int q = 0; q < T::STEPS; ++q) {
          hop::wgmma_tf32(tmp, as[q], big + 2 * q, q > 0);
          hop::wgmma_tf32(tmp, ab[q], small + 2 * q, 1);
          hop::wgmma_tf32(tmp, ab[q], big + 2 * q, 1);
        }
      } else {
        uint32_t a[T::STEPS][4];
#pragma unroll
        for (int q = 0; q < T::STEPS; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // pairs (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
            const int r = row + 8 * (e & 1), d = 16 * q + 2 * t + 8 * (e >> 1);
            if constexpr (COLS && T::kInt8) {
              const uint32_t lo = st[xat(d, r)], hi = st[xat(d + 1, r)];
              a[q][e] = hop::bf16x2_of_s8x2(lo | hi << 8);
            } else if constexpr (COLS) {
              const uint32_t lo = *reinterpret_cast<const uint16_t*>(st + xat(d, r));
              const uint32_t hi = *reinterpret_cast<const uint16_t*>(st + xat(d + 1, r));
              a[q][e] = lo | hi << 16;
            } else {  // a pair along the row: on 2 (int8) or 4 bytes only in TMA's tiles
              const uint8_t* at = st + xat(r, d);
              if constexpr (T::kInt8)
                a[q][e] = hop::bf16x2_of_s8x2(tma ? *reinterpret_cast<const uint16_t*>(at)
                                                  : at[0] | (uint32_t)at[1] << 8);
              else
                a[q][e] = tma ? *reinterpret_cast<const uint32_t*>(at)
                              : *reinterpret_cast<const uint16_t*>(at) |
                                    (uint32_t)*reinterpret_cast<const uint16_t*>(at + 2) << 16;
            }
          }
        hop::wgmma_fence();
#pragma unroll
        for (int q = 0; q < T::STEPS; ++q) hop::wgmma_bf16(tmp, a[q], big + 2 * q, q > 0);
      }
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::pin(tmp);
      hop::mbar_arrive(&empty[slot]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += tmp[i];
    }

    const bool direct = gridDim.z == 1;
    float* dst = COLS ? (direct ? out : out + (long long)blockIdx.z * k * n)
                      : out + (long long)blockIdx.z * rows * k;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int go = o0 + row + 8 * ((i >> 1) & 1), gc = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (gc >= k) continue;
      if constexpr (COLS) {
        if (go >= n) continue;
        float* o = dst + (long long)gc * n + go;
        *o = (direct && !first ? *o : 0.f) + acc[i];
      } else {
        if (go >= r1) continue;
        dst[(long long)(go - r0) * k + gc] = acc[i];
      }
    }
  }
}

// Stage (B)'s factor from W' (m, k) for the rows [r0, r1): W'^T (k, ldm),
// FT f32: its TF32 big and small parts (tc::split), bf16: rounded to bf16
// (as torch's .to); grid (ceil((r1 - r0) / 32), ceil(k / 32)).
template <typename FT>
__global__ void __launch_bounds__(kThreads)
    wt_operand_kernel(const float* __restrict__ w, int k, int r0, int r1, int ldm,
                      FT* __restrict__ big, FT* __restrict__ small) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int i0 = r0 + blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int r = ty; r < 32; r += 8) {
    const int gi = i0 + r, gc = c0 + tx;
    tile[r][tx] = gi < r1 && gc < k ? w[(long long)gi * k + gc] : 0.f;
  }
  __syncthreads();
  for (int c = ty; c < 32; c += 8) {
    const int gc = c0 + c, gi = i0 + tx;
    if (gc >= k || gi >= r1) continue;
    const long long o = (long long)gc * ldm + gi;
    if constexpr (std::is_same_v<FT, float>) {
      uint32_t b, sm;
      tc::split(tile[tx][c], b, sm);
      big[o] = __uint_as_float(b);
      small[o] = __uint_as_float(sm);
    } else {
      big[o] = __float2bfloat16(tile[tx][c]);
    }
  }
}

// The scratch of the TMA stages: the plan's (partials, den), then (B)'s
// factor W'^T (k, ldm) in the factors' type (TmaTile::FT), f32: big then
// small.
struct TmaScratch {
  Plan p;
  int ldm;
  long long wt, total;  // float offsets, in 64 bits
};

inline TmaScratch tma_scratch(int m, int n, int k, int x_bytes) {
  TmaScratch sc;
  sc.p = make_plan(m, n, k, x_bytes, kWaveEuTc, kTmaFill);
  sc.ldm = round_up(m, 8);  // 16-byte rows for TMA
  sc.wt = (sc.p.scratch + 3) / 4 * 4;
  // f32 X: two f32 parts; bf16 and int8 X: one bf16
  const long long bytes = (long long)k * sc.ldm * (x_bytes == 4 ? 8 : 2);
  sc.total = sc.wt + (bytes + 3) / 4;
  return sc;
}

// ----------------------------------------------------------- the stages
// The pair of stage kernels a wave runs: rows(p, r0, r1, part, s) (A) into
// part, cols(p, w_new, r0, r1, first, wtx, part, s) (B) into wtx (or part).

// mma.sync on the tensor cores (mur_iteration_eu, hals_iteration_eu): f is
// H (k, n) in X's type.
template <typename XT>
struct TcStages {
  const XT* x;
  const XT* f;
  int n, k;
  cudaError_t rows(const Plan& p, int r0, int r1, float* part, cudaStream_t s) const {
    constexpr int V = 16 / sizeof(XT);
    const bool aligned = n % V == 0 && aligned16(x) && aligned16(f);
    return launch(eu_rows_tc_kernel<XT>,
                  dim3(ceil_div(r1 - r0, kTcTile), ceil_div(k, kTcTile), p.nsplit),
                  sizeof(typename RowsTile<XT>::Stage), s, x, f, n, k, r0, r1, p.rows,
                  p.a_cols, aligned, part);
  }
  cudaError_t cols(const Plan& p, const float* w_new, int r0, int r1, bool first, float* wtx,
                   float* part, cudaStream_t s) const {
    return tc_cols(x, w_new, n, k, r0, r1, p.b_rows, p.msplit, first, wtx, part, s);
  }
};

// TMA and wgmma (the "dma" variant, v1_iter, v2_iter, iter_eu_int8): the
// factor of (A) is H (k, n) at row stride ldh (f32 X: f0 its TF32 big part,
// f1 its small part; bf16 and int8 X: f0 in bf16), of (B) W'^T in `wt`
// (tma_scratch's layout).  make() encodes the tensor maps.
template <typename XT>
struct TmaStages {
  using T = TmaTile<XT>;
  using FT = typename T::FT;
  CUtensorMap xrows, xcols, h0, h1, w0, w1;
  const XT* x;
  FT* wt;
  int m, n, k, ldm;
  bool tma;  // X's rows start on 16 bytes: its tiles by TMA, else by hop::copy_rows

  cudaError_t make(const XT* x_, const FT* f0, const FT* f1, int ldh, int m_, int n_, int k_,
                   FT* wt_, int ldm_) {
    x = x_, wt = wt_, m = m_, n = n_, k = k_, ldm = ldm_;
    std::memset(&xrows, 0, sizeof(xrows));
    std::memset(&xcols, 0, sizeof(xcols));
    tma = aligned16(x) && ((long long)n * T::ES) % 16 == 0;
    cudaError_t err = cudaSuccess;
    if (tma) {
      err = hop::make_map(&xrows, x, m, n, n, T::BM, T::KC);
      if (err == cudaSuccess) err = hop::make_map(&xcols, x, m, n, n, T::KC, T::XC);
    }
    FT* small = wt + (long long)k * ldm;
    if (err == cudaSuccess) err = hop::make_map(&h0, f0, k, n, ldh, T::BN, T::KC);
    if (err == cudaSuccess) err = hop::make_map(&h1, T::kF32 ? f1 : f0, k, n, ldh, T::BN, T::KC);
    if (err == cudaSuccess) err = hop::make_map(&w0, wt, k, m, ldm, T::BN, T::KC);
    if (err == cudaSuccess) err = hop::make_map(&w1, T::kF32 ? small : wt, k, m, ldm, T::BN, T::KC);
    return err;
  }

  template <bool COLS>
  cudaError_t run(dim3 grid, const CUtensorMap& xm, const CUtensorMap& a, const CUtensorMap& b,
                  int r0, int r1, int rows, int chunk, bool first, float* out,
                  cudaStream_t s) const {
    auto kernel = tma ? eu_tma_kernel<XT, COLS, true> : eu_tma_kernel<XT, COLS, false>;
    const int smem = tma ? T::SMEM : TmaTile<XT, false>::SMEM;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kTmaThreads, smem, s>>>(xm, a, b, x, m, n, k, r0, r1, rows, chunk, first,
                                           out);
    return cudaGetLastError();
  }
  cudaError_t rows(const Plan& p, int r0, int r1, float* part, cudaStream_t s) const {
    return run<false>(dim3(ceil_div(r1 - r0, T::BM), ceil_div(k, T::BN), p.nsplit), xrows, h0,
                      h1, r0, r1, p.rows, p.a_cols, true, part, s);
  }
  cudaError_t cols(const Plan& p, const float* w_new, int r0, int r1, bool first, float* wtx,
                   float* part, cudaStream_t s) const {
    cudaError_t err = launch(wt_operand_kernel<FT>, dim3(ceil_div(r1 - r0, 32), ceil_div(k, 32)),
                             0, s, w_new, k, r0, r1, ldm, wt, wt + (long long)k * ldm);
    if (err != cudaSuccess) return err;
    return run<true>(dim3(ceil_div(n, T::BM), ceil_div(k, T::BN), p.msplit), xcols, w0, w1, r0,
                     r1, p.rows, p.b_rows, first, p.msplit == 1 ? wtx : part, s);
  }
};

// The EU waves: per wave (A), epilogue(r0, r1) (which writes W' for the
// wave's rows [r0, r1) into w_out from the partials at scratch + p.a_part),
// (B); then gram = W'^T W'.  p was made for the stages' plan kind.
template <class Stages, typename Epilogue>
cudaError_t eu_waves(const Plan& p, const Stages& stages, int m, int n, int k,
                     Epilogue epilogue, float* w_out, float* wtx, float* gram, float* scratch,
                     cudaStream_t s) {
  const int ktiles = ceil_div(k, kTile);
  cudaError_t err = cudaSuccess;
  for (int wave = 0; wave < p.waves && err == cudaSuccess; ++wave) {
    const int r0 = wave * p.rows, r1 = std::min(r0 + p.rows, m);
    err = stages.rows(p, r0, r1, scratch + p.a_part, s);
    if (err != cudaSuccess) break;
    err = epilogue(r0, r1);
    if (err != cudaSuccess) break;
    const int msplit = ceil_div(r1 - r0, p.b_rows);
    err = stages.cols(p, w_out, r0, r1, wave == 0, wtx, scratch + p.b_part, s);
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

// The MUR EU single pass: den = W Gh, then the EU waves of `stages` (on
// plan p) with the W update as epilogue.
template <class Stages>
cudaError_t mur_eu_waves(const Plan& p, const Stages& stages, const float* w, const float* gh,
                         float lam, const float* scale, int m, int n, int k, float* w_out,
                         float* wtx, float* gram, float* scratch, cudaStream_t s) {
  const float* den = scratch + p.den;
  const float* part = scratch + p.a_part;
  cudaError_t err = launch(eu_den_kernel, dim3(ceil_div(m, kTile), ceil_div(k, kTile)), 0, s, w,
                           gh, m, k, scratch + p.den);
  if (err != cudaSuccess) return err;
  auto w_update = [&](int r0, int r1) {
    return launch(eu_w_kernel, elementwise_grid((long long)(r1 - r0) * k), 0, s, w, den, part,
                  p.nsplit, lam, scale, k, r0, r1, p.rows, w_out);
  };
  return eu_waves(p, stages, m, n, k, w_update, w_out, wtx, gram, scratch, s);
}

// The MUR EU single pass on TMA and wgmma: f0, f1 and ldh as TmaStages takes
// them, scale as mur_eu_waves; scratch holds scratch_len floats, at least
// tma_scratch's total (fewer: cudaErrorInvalidValue).
template <typename XT>
cudaError_t mur_eu_tma(const void* x, const void* f0, const void* f1, int ldh, const float* w,
                       const float* gh, float lam, const float* scale, int m, int n, int k,
                       float* w_out, float* wtx, float* gram, float* scratch,
                       long long scratch_len, cudaStream_t s) {
  using FT = typename TmaTile<XT>::FT;
  const TmaScratch sc = tma_scratch(m, n, k, sizeof(XT));
  if (scratch_len < sc.total) return cudaErrorInvalidValue;
  TmaStages<XT> stages;
  cudaError_t err = stages.make(static_cast<const XT*>(x), static_cast<const FT*>(f0),
                                static_cast<const FT*>(f1), ldh, m, n, k,
                                reinterpret_cast<FT*>(scratch + sc.wt), sc.ldm);
  if (err != cudaSuccess) return err;
  return mur_eu_waves(sc.p, stages, w, gh, lam, scale, m, n, k, w_out, wtx, gram, scratch, s);
}

}  // namespace
}  // namespace tpunmf
