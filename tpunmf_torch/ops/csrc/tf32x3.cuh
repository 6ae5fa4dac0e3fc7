// f32-accurate matrix products on Hopper's tensor cores: 3xTF32 mma.sync.
//
// An f32 value a is split into two TF32 values: big = a rounded to TF32
// (10 mantissa bits kept) and small = a - big, exact in f32; a product a*b
// is then big*big + big*small + small*big, the small*small term (below
// 2^-22 relative) left out.  Each of the three is one
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, accumulated in f32, so
// a k-step of 8 costs three tensor-core instructions and the sums keep about
// f32's accuracy (one TF32 product keeps about three digits, too few for the
// kernels' 1e-4 checks and for the KL kernels' division by W H + eps).  On
// the H100 that is 495 / 3 = 165 TFLOP/s of f32 work at the TF32 peak,
// against 67 for f32 FMA.
//
// The split is integer work, not cvt.rna.tf32.f32, which runs on the
// conversion pipe (16 results a clock an SM; the integer split made the
// S tile 10-20% faster on an H100).  big rounds half an ulp up in
// magnitude (add 2^12 to the bits, clear the low 13: CUTLASS's
// round_half_ulp_truncate); small goes to the tensor cores as it is, and
// they read a TF32 operand's top 19 bits, so its truncation costs at most
// 2^-10 of small, about 2^-21 of a.
//
// Used by objective.cu (the objective and ratio passes), masked_update.cu
// (both masked passes and MUR's KL H pass) and, through tile_mma, the MUR EU
// products (wave.cuh: mur_iteration_eu's stages; mur_update.cu's EU H
// pass); wave.cuh's TMA stages take its split for their 3xTF32 wgmma.  Fragments follow the PTX layouts of m16n8k8 with
// .tf32 operands, lane = 4 g + t:
//   A (16 x 8, row):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, col):   b0 (t, g)  b1 (t+4, g)
//   C (16 x 8):       c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
// Operands come from shared memory whose row strides keep every fragment
// load free of bank conflicts: a stride = 4 (mod 32) for A read along its
// rows and for B stored column by column (each column a row of the tile),
// = 8 (mod 32) for A read down its columns (a transposed tile) and for B
// stored depth-major.  No float atomics anywhere.
#pragma once

#include "common.cuh"

namespace tpunmf {
namespace tc {

// v = big + small: big is v rounded to TF32, small = v - big exactly
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A B with a zero accumulator (warp_mma's ROUNDED steps).
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  const float zero = 0.f;
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(zero));
}

// An operand fragment split in its TF32 parts.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

// Pass P of d += A B in 3xTF32: 0 small*big, 1 big*small, 2 big*big (the
// small terms first).
template <int P>
__device__ __forceinline__ void mma_pass(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  if constexpr (P == 0) mma_tf32(d, a.small, b.big);
  if constexpr (P == 1) mma_tf32(d, a.big, b.small);
  if constexpr (P == 2) mma_tf32(d, a.big, b.big);
}

// The A fragment of rows [r0, r0+16) and depth [k0, k0+8) of a tile in
// shared memory: A(r, kk) = s[r * ld + kk], or with TRANS s[kk * ld + r].
// T: the staged type, float or bf16 (a bf16 value is exact in TF32, so its
// small part is 0).
template <bool TRANS, typename T = float>
__device__ __forceinline__ void load_a(Frag<4>& f, const T* s, int ld, int r0, int k0,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int rows[4] = {g, g + 8, g, g + 8}, cols[4] = {t, t, t + 4, t + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + rows[i], kk = k0 + cols[i];
    split(to_f32(TRANS ? s[kk * ld + r] : s[r * ld + kk]), f.big[i], f.small[i]);
  }
}

// The B fragment of depth [k0, k0+8) and columns [c0, c0+8) of a tile in
// shared memory stored depth-major: B(kk, c) = s[kk * ld + c], or with COL
// column by column (mma's own .col layout): B(kk, c) = s[c * ld + kk].
template <bool COL = false, typename T = float>
__device__ __forceinline__ void load_b(Frag<2>& f, const T* s, int ld, int k0, int c0,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int c = c0 + g, k1 = k0 + t, k2 = k0 + t + 4;
  split(to_f32(COL ? s[c * ld + k1] : s[k1 * ld + c]), f.big[0], f.small[0]);
  split(to_f32(COL ? s[c * ld + k2] : s[k2 * ld + c]), f.big[1], f.small[1]);
}

// A warp's MT x NT grid of 16 x 8 accumulator tiles.
template <int MT, int NT>
using Acc = float[MT][NT][4];

template <int MT, int NT>
__device__ __forceinline__ void zero(Acc<MT, NT>& acc) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// Pass P of one 8-deep step over every (i, j) of a warp's tiles.  The
// three passes go in turn, each across all the tiles, so that the three
// dependent products of an accumulator are MT * NT issues apart.
template <int P, int MT, int NT>
__device__ __forceinline__ void pass_all(Acc<MT, NT>& acc, const Frag<4> (&a)[MT],
                                         const Frag<2> (&b)[NT]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_pass<P>(acc[i][j], a[i], b[j]);
}

// The same for one row i of tiles.
template <int P, int MT, int NT>
__device__ __forceinline__ void pass_row(Acc<MT, NT>& acc, int i, const Frag<4>& a,
                                         const Frag<2> (&b)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_pass<P>(acc[i][j], a, b[j]);
}

// One 8-deep step of d += A B over the warp's tiles: the three passes in
// turn, or with EXACT (every operand value exact in TF32, as bf16 values
// are: their small parts are 0) the big*big pass alone, which gives the
// same products.
template <bool EXACT, int MT, int NT>
__device__ __forceinline__ void step_all(Acc<MT, NT>& acc, const Frag<4> (&a)[MT],
                                         const Frag<2> (&b)[NT]) {
  if constexpr (!EXACT) {
    pass_all<0>(acc, a, b);
    pass_all<1>(acc, a, b);
  }
  pass_all<2>(acc, a, b);
}

// acc += A[r0 : r0+16 MT, k-range] B[k-range, c0 : c0+8 NT] over `depth`
// (a multiple of 8) from shared tiles: A as load_a<TRANS> reads it, B
// depth-major.  With MT <= 2 a step's A fragments are all held at once;
// above that one row of tiles at a time (registers), its NT accumulators
// taking each pass in turn.
//
// The tensor cores truncate a sum they accumulate, so the three passes'
// additions into acc leave S short by a few ulps a step, all one way.
// Where S is subtracted from X (0.5 ||X - W H||^2 near convergence) that
// costs digits: on an H100, at k 64 and a residual of 1e-3 of X, the
// objective was 1.0e-6 off (relative) against 8.6e-8 for f32 products
// (tests/test_torch_cuda.py, near convergence).  With ROUNDED, each step's
// three products go into a fresh accumulator, added to acc in f32 with
// round to nearest: the objective then is as close as f32 products', for
// 16 more registers a row of tiles and one add an entry a step (the EU
// objective 17-22% slower on an H100).  The KL objective needs it too: it
// moves by S's bias times sum(W H - X), which near a fit can be a hundred
// times the objective (objective.cu).  So does a long sum: MUR's KL
// numerators (masked_update.cu, about a thousand steps at m = 8192) round
// their steps, which costs those passes 0.7-2.5% on an H100, and so do
// the masked W pass's two sums (warp_mma2), 3.5-3.9% there.
//
// BCOL: B is read column by column as load_b<true> does; EXACT: every
// operand value is exact in TF32 (bf16 operands), so one TF32 product a
// step gives the 3xTF32 products (step_all).  The staged types TA, TB are
// float or bf16.
template <int MT, int NT, bool TRANS, bool ROUNDED = false, bool BCOL = false,
          bool EXACT = false, typename TA, typename TB>
__device__ __forceinline__ void warp_mma(Acc<MT, NT>& acc, const TA* a, int lda, const TB* b,
                                         int ldb, int r0, int c0, int depth, int lane) {
#pragma unroll 2
  for (int k0 = 0; k0 < depth; k0 += 8) {
    Frag<2> bf[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) load_b<BCOL>(bf[j], b, ldb, k0, c0 + 8 * j, lane);
    if constexpr (ROUNDED) {
      constexpr int RT = MT <= 2 ? MT : 1;  // rows of tiles a round
#pragma unroll
      for (int i0 = 0; i0 < MT; i0 += RT) {
        Frag<4> af[RT];
        Acc<RT, NT> t;
#pragma unroll
        for (int i = 0; i < RT; ++i) load_a<TRANS>(af[i], a, lda, r0 + 16 * (i0 + i), k0, lane);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if constexpr (EXACT)
              mma_tf32_fresh(t[i][j], af[i].big, bf[j].big);
            else
              mma_tf32_fresh(t[i][j], af[i].small, bf[j].big);
          }
        if constexpr (!EXACT) {
          pass_all<1>(t, af, bf);
          pass_all<2>(t, af, bf);
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i0 + i][j][q] += t[i][j][q];
      }
    } else if constexpr (MT <= 2) {
      Frag<4> af[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) load_a<TRANS>(af[i], a, lda, r0 + 16 * i, k0, lane);
      step_all<EXACT>(acc, af, bf);
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        Frag<4> af;
        load_a<TRANS>(af, a, lda, r0 + 16 * i, k0, lane);
        if constexpr (!EXACT) {
          pass_row<0>(acc, i, af, bf);
          pass_row<1>(acc, i, af, bf);
        }
        pass_row<2>(acc, i, af, bf);
      }
    }
  }
}

// acc0 += A B0 and acc1 += A B1 as warp_mma does, the A fragments loaded
// and split once a step for both (MT <= 2); B0 and B1 as load_b<BCOL>
// reads them.  ROUNDED as in warp_mma: each step's products go into two
// fresh accumulators, added to acc0 and acc1 with round to nearest (the
// masked W pass's numerator and denominator, masked_update.cu).
template <int MT, int NT, bool TRANS, bool ROUNDED = false, bool BCOL = false>
__device__ __forceinline__ void warp_mma2(Acc<MT, NT>& acc0, Acc<MT, NT>& acc1, const float* a,
                                          int lda, const float* b0, const float* b1, int ldb,
                                          int r0, int c0, int depth, int lane) {
  static_assert(MT <= 2, "one step's A fragments are held at once");
#pragma unroll 2
  for (int k0 = 0; k0 < depth; k0 += 8) {
    Frag<2> bf0[NT], bf1[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      load_b<BCOL>(bf0[j], b0, ldb, k0, c0 + 8 * j, lane);
      load_b<BCOL>(bf1[j], b1, ldb, k0, c0 + 8 * j, lane);
    }
    Frag<4> af[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) load_a<TRANS>(af[i], a, lda, r0 + 16 * i, k0, lane);
    if constexpr (ROUNDED) {
      Acc<MT, NT> t0, t1;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_tf32_fresh(t0[i][j], af[i].small, bf0[j].big);
          mma_tf32_fresh(t1[i][j], af[i].small, bf1[j].big);
        }
      pass_all<1>(t0, af, bf0);
      pass_all<1>(t1, af, bf1);
      pass_all<2>(t0, af, bf0);
      pass_all<2>(t1, af, bf1);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc0[i][j][q] += t0[i][j][q];
            acc1[i][j][q] += t1[i][j][q];
          }
    } else {
      pass_all<0>(acc0, af, bf0);
      pass_all<0>(acc1, af, bf1);
      pass_all<1>(acc0, af, bf0);
      pass_all<1>(acc1, af, bf1);
      pass_all<2>(acc0, af, bf0);
      pass_all<2>(acc1, af, bf1);
    }
  }
}

// Calls f2(row, col, v0, v1) for each pair of neighbouring accumulator
// entries (row, col) and (row, col + 1) of a warp's tiles, the warp's
// origin at (r0, c0).
template <int MT, int NT, typename F2>
__device__ __forceinline__ void for_pairs(const Acc<MT, NT>& acc, int r0, int c0, int lane,
                                          F2 f2) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = r0 + 16 * i + g, c = c0 + 8 * j + 2 * t;
      f2(r, c, acc[i][j][0], acc[i][j][1]);
      f2(r + 8, c, acc[i][j][2], acc[i][j][3]);
    }
}

// ------------------------------------------------------------- the S tile
// S = W[row0 : row0+BM, :] H[:, col0 : col0+BN] over the full rank k (1 to
// 2048), with W (m, k) and H (k, n) row-major f32; zero outside the
// matrices.  The block's 256 threads are WM x WN warps (WM * WN = 8), each
// owning a (BM / WM) x (BN / WN) piece of S as MT x NT accumulator tiles.
// k is staged KC deep in two shared buffers filled by cp.async: the next
// chunk's copies are in flight while the current one is multiplied.
template <int BM, int BN, int WM, int WN>
struct STile {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static constexpr int KC = 32, LDW = KC + 4, LDH = BN + 8;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int WROWS = BM / WM, WCOLS = BN / WN;
  struct Stage {
    alignas(16) float w[2][BM * LDW];
    alignas(16) float h[2][KC * LDH];
  };
  // the warp's origin in the block tile
  __device__ static int warp_row(int warp) { return (warp / WN) * WROWS; }
  __device__ static int warp_col(int warp) { return (warp % WN) * WCOLS; }
};

// s = the warp's piece of S.  `w_aligned` / `h_aligned`: every row of W / H
// starts on 16 bytes (k % 4 == 0 / n % 4 == 0 and an aligned base); else
// the copies go by plain loads.  ROUNDED: warp_mma's accumulation rounded
// to nearest at every 8-deep step.  Commits its own cp.async groups and
// waits for all of them (and any committed before it); every thread of the
// block must call it, and it ends with __syncthreads().
template <int BM, int BN, int WM, int WN, bool ROUNDED = false>
__device__ __forceinline__ void s_tile(
    Acc<STile<BM, BN, WM, WN>::MT, STile<BM, BN, WM, WN>::NT>& s, const float* __restrict__ w,
    const float* __restrict__ h, int m, int n, int k, int row0, int col0, bool w_aligned,
    bool h_aligned, typename STile<BM, BN, WM, WN>::Stage& st) {
  using T = STile<BM, BN, WM, WN>;
  constexpr int KC = T::KC, LDW = T::LDW, LDH = T::LDH;
  constexpr int WP = BM * (KC / 4), HP = KC * (BN / 4);  // 16-byte pieces
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto issue = [&](int buf, int k0) {
    for (int l = tid; l < WP + HP; l += kThreads) {
      if (l < WP) {
        const int r = l / (KC / 4), c = l % (KC / 4) * 4, gr = row0 + r, gk = k0 + c;
        stage_piece(st.w[buf] + r * LDW + c, w + (long long)gr * k + gk,
                    gr < m ? k - gk : 0, w_aligned);
      } else {
        const int q = l - WP, r = q / (BN / 4), c = q % (BN / 4) * 4, gk = k0 + r,
                  gc = col0 + c;
        stage_piece(st.h[buf] + r * LDH + c, h + (long long)gk * n + gc,
                    gk < k ? n - gc : 0, h_aligned);
      }
    }
    cp_async_commit();
  };
  zero(s);
  const int r0 = T::warp_row(warp), c0 = T::warp_col(warp);
  issue(0, 0);
  int buf = 0;
  for (int k0 = 0; k0 < k; k0 += KC, buf ^= 1) {
    if (k0 + KC < k)
      issue(buf ^ 1, k0 + KC);
    else
      cp_async_commit();  // an empty group: wait_one then always means "this chunk"
    cp_async_wait_one();
    __syncthreads();
    warp_mma<T::MT, T::NT, false, ROUNDED>(s, st.w[buf], LDW, st.h[buf], LDH, r0, c0, KC,
                                           lane);
    __syncthreads();  // the chunk is read before the next issue overwrites it
  }
}

// ------------------------------------------------------ the product tile
// acc += A B for a block's BM x BN tile over a depth range, both operands
// staged from device memory KC deep in two shared buffers by cp.async: the
// next chunk's copies are in flight while the current one is multiplied.
// The operands keep their layout and type (float or bf16) in shared memory:
//   A (BM x depth): read along its rows, A(r, d) = a[r * lda + d] (X's rows
//       against H in the EU single pass's stage A), or with A_DEPTH down
//       its columns, A(r, d) = a[d * lda + r] (a factor's rows against X);
//   B (depth x BN): column by column with B_COLS, B(d, c) = b[c * ldb + d]
//       (H's rows), else depth-major, B(d, c) = b[d * ldb + c] (X's rows).
// A staged row is padded by 16 bytes where the depth runs along it and by
// 32 where it runs across rows: line strides of 4 (f32) or 8 (bf16) times
// an odd number of elements, and 8 or 16 times an odd number, which keep
// every fragment load free of bank conflicts (a bf16 pair shares a word).
template <int BM, int BN, int WM, int WN, typename TA_, typename TB_, bool A_DEPTH_,
          bool B_COLS_>
struct Tile {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  using TA = TA_;
  using TB = TB_;
  static constexpr bool A_DEPTH = A_DEPTH_, B_COLS = B_COLS_;
  static constexpr int KC = 32;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int WROWS = BM / WM, WCOLS = BN / WN;
  static constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);  // a 16-byte piece
  static constexpr int LDA = A_DEPTH ? BM + 2 * VA : KC + VA;
  static constexpr int LDB = B_COLS ? KC + VB : BN + 2 * VB;
  static constexpr int A_LINES = A_DEPTH ? KC : BM, A_WIDTH = A_DEPTH ? BM : KC;
  static constexpr int B_LINES = B_COLS ? BN : KC, B_WIDTH = B_COLS ? KC : BN;
  static constexpr int PA = A_LINES * A_WIDTH / VA, PB = B_LINES * B_WIDTH / VB;  // pieces
  struct Stage {
    alignas(16) TA a[2][A_LINES * LDA];
    alignas(16) TB b[2][B_LINES * LDB];
  };
  // the warp's origin in the block tile
  __device__ static int warp_row(int warp) { return (warp / WN) * WROWS; }
  __device__ static int warp_col(int warp) { return (warp % WN) * WCOLS; }
};

// acc (the warp's piece of the tile) += A B over depth [0, depth), reading
// only rows r < a_rows of A, columns c < b_cols of B and d < depth (zeros
// beyond; nothing at all where depth <= 0).  a and b point at the tile's
// origin, with line strides lda, ldb; `a_aligned` / `b_aligned`: every line
// starts on 16 bytes, else the copies go by plain loads.  EXACT and
// ROUNDED as warp_mma.  RA: A's staged f32 values are rounded to RA's type
// (round to nearest even, as torch's .to) as they land, where the product
// takes an f32 factor in X's type (bf16 X); float leaves them.  Commits its
// own cp.async groups and waits for all of them; every thread of the block
// calls it, and where depth > 0 it ends with __syncthreads().
template <class T, bool EXACT, bool ROUNDED, typename RA = float>
__device__ __forceinline__ void tile_mma(Acc<T::MT, T::NT>& acc, const typename T::TA* a,
                                         int lda, int a_rows, const typename T::TB* b, int ldb,
                                         int b_cols, int depth, bool a_aligned, bool b_aligned,
                                         typename T::Stage& st) {
  constexpr int KC = T::KC, VA = T::VA, VB = T::VB;
  constexpr int AW = T::A_WIDTH / VA, BW = T::B_WIDTH / VB;  // pieces a staged line
  constexpr bool kRound = !std::is_same_v<RA, float>;
  static_assert(!kRound || std::is_same_v<typename T::TA, float>, "rounds f32 values");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (depth <= 0) return;
  auto issue = [&](int buf, int d0) {
    for (int l = tid; l < T::PA + T::PB; l += kThreads) {
      if (l < T::PA) {
        const int line = l / AW, c = l % AW * VA;
        // A_DEPTH: line d0 + line of the depth, columns c.. of A's rows;
        // else row `line` of A, depth d0 + c..
        const long long at = T::A_DEPTH ? (long long)(d0 + line) * lda + c
                                        : (long long)line * lda + d0 + c;
        const int valid = T::A_DEPTH ? (d0 + line < depth ? a_rows - c : 0)
                                     : (line < a_rows ? depth - d0 - c : 0);
        stage_piece(st.a[buf] + line * T::LDA + c, a + at, valid, a_aligned);
      } else {
        const int q = l - T::PA, line = q / BW, c = q % BW * VB;
        const long long at = T::B_COLS ? (long long)line * ldb + d0 + c
                                       : (long long)(d0 + line) * ldb + c;
        const int valid = T::B_COLS ? (line < b_cols ? depth - d0 - c : 0)
                                    : (d0 + line < depth ? b_cols - c : 0);
        stage_piece(st.b[buf] + line * T::LDB + c, b + at, valid, b_aligned);
      }
    }
    cp_async_commit();
  };
  const int r0 = T::warp_row(warp), c0 = T::warp_col(warp);
  issue(0, 0);
  int buf = 0;
  for (int d0 = 0; d0 < depth; d0 += KC, buf ^= 1) {
    if (d0 + KC < depth)
      issue(buf ^ 1, d0 + KC);
    else
      cp_async_commit();  // an empty group: wait_one then always means "this chunk"
    cp_async_wait_one();
    if constexpr (kRound) {  // this thread's own pieces, landed
      for (int l = tid; l < T::PA; l += kThreads) {
        float* p = st.a[buf] + l / AW * T::LDA + l % AW * VA;
#pragma unroll
        for (int v = 0; v < VA; ++v) p[v] = round_as_x<RA>(p[v]);
      }
    }
    __syncthreads();
    warp_mma<T::MT, T::NT, T::A_DEPTH, ROUNDED, T::B_COLS, EXACT>(
        acc, st.a[buf], T::LDA, st.b[buf], T::LDB, r0, c0, KC, lane);
    __syncthreads();  // the chunk is read before the next issue overwrites it
  }
}

}  // namespace tc
}  // namespace tpunmf
