// The HALS Gauss-Seidel sweep, blocked for the H100: shared by gs_sweep
// (hals_sweep.cu) and the single-pass HALS iteration's sweep epilogue
// (hals_iteration.cu).  nsweeps passes, over every column c of V (k, M), of
//
//   for l in 0..k-1:
//     numer   = A[l, c] - G[l, :] . V[:, c] + G[l, l] V[l, c]
//     V[l, c] = max(numer / d[l], 0),     d[l] = (G[l, l] + lam) + eps
//
// (eps = 1e-16, tpunmf/solvers/hals.py:54-81; the max keeps a NaN).
//
// What bounds it: 2 k^2 flops a column a sweep (0.54 GFLOP at 8192
// columns, k = 128, 2 sweeps: 0.008 ms on f32 FMA, 0.003 ms at 3xTF32) on
// 3 k M floats of device memory (0.004 ms), but the chain is serial along k,
// so a step's latency times k sets the pace of a column.  The chain this
// replaced (one warp a column recomputing G[l, :] . V with a 5-level
// shuffle butterfly and one lane dividing) issued ~38 instructions and
// waited ~200 cycles a step.  Design, blocked Gauss-Seidel:
//  * A block of 256 threads owns C consecutive columns; their (k x C) tile
//    of V lives in shared memory for the whole call (stored column by
//    column, each column's k values contiguous), loaded and stored so that
//    neighbouring threads touch neighbouring addresses in either frame (the
//    H frame's rows of H, the W frame's rows of W as a transposed view).
//  * The rows go in panels of B.  For the panel [l0, l0 + B):
//    (a) P = G[l0 : l0+B, :] V from V as it stands (the rows before l0
//        already updated this sweep, the panel's own not yet): all of the
//        k^2 work, on the tensor cores (3xTF32 mma.sync, every 8-deep
//        step's sum rounded to nearest: tf32x3.cuh's warp_mma), 8 warps,
//        each NT tiles of 16 x 8 over one of S slices of k, added in order;
//    (b) the panel's B steps, one thread a column:
//          numer = (A[l] - P[l] + G[l, l] V_old[l]) - corr[l]
//          V[l]  = max(numer / d[l], 0),   delta = V[l] - V_old[l]
//          corr[r] += G[r, l] delta          (the panel's later rows r)
//        so that G[l, :] . V = P[l] + corr[l] in exact arithmetic.  A
//        step's serial path is a subtraction, the IEEE division, the clamp
//        and one FMA into the next row's correction; the other FMAs are
//        independent.  P is formed afresh at every panel and a correction
//        lives at most B steps, so nothing drifts along a sweep (the TPU
//        kernel's running P = G V with a rank-1 update a step,
//        tpunmf/ops/hals_sweep.py:41-61, drifted past 1e-4 on the card).
//  * G's and A's rows of the next panel come by cp.async into the other
//    buffer of a ring of two, issued by the warps that run no chain while
//    the chain runs: on an H100 a load into registers before a block
//    barrier held the barrier until it landed, and copies issued beside
//    the product took its warps' issue slots (PERF.md).  d[l] = (G[l, l] +
//    lam) + eps is formed once a call, in tpunmf's order.  Two block
//    barriers a panel.
//  * B, C and S are set per k at compile time (with_panel): at k <= 256 64
//    columns a block (128 blocks at 8192 columns, one wave), above that 32
//    and 16 so that the tile of V and the ring fit in 227 KB.
// Built without --use_fast_math: the division stays IEEE.
#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace tpunmf {
namespace {

constexpr float kHalsEps = 1e-16f;  // tpunmf/ops/hals_sweep.py:38

// The panel height B and the column tile C of a sweep kernel, the splits S
// of its product along k, and its shared memory: V's tile vs[c * ld + l]
// (C columns), G's panel rows gs[buf][r * ld + l] and A's as[buf][r * LDP +
// c] in a ring of two panels, the product's partials red[s][r * LDP + c],
// G[l, l] and d[l] (kpad each); ld = kpad + 4 with kpad = k rounded up to
// 32 keeps the fragment loads free of bank conflicts (tf32x3.cuh).
template <int B_, int C_, int S_>
struct Panel {
  static constexpr int B = B_, C = C_, S = S_;
  static_assert(B % 16 == 0 && C % 8 == 0, "whole 16 x 8 tiles");
  static constexpr int TILES = (B / 16) * (C / 8);
  static constexpr int NT = TILES * S / 8;  // 16 x 8 tiles a warp, along C
  static constexpr int NW = C / 8 / NT;     // warps along C
  static_assert(TILES * S % 8 == 0 && NT > 0 && (C / 8) % NT == 0,
                "8 warps over the panel's tiles and splits");
  static constexpr int LDP = C + 4;
  __host__ __device__ static int kpad(int k) { return (k + 31) / 32 * 32; }
  __host__ __device__ static int ld(int k) { return kpad(k) + 4; }
  static size_t smem_bytes(int k) {
    return sizeof(float) *
           ((size_t)(C + 2 * B) * ld(k) + (size_t)(2 + S) * B * LDP + 2 * kpad(k));
  }
};

// gs_sweep's operands: a, v and out (k, cols) at base + row * s0 + col * s1.
struct StridedFrame {
  const float* a;
  int a_s0, a_s1;
  const float* v;
  int v_s0, v_s1;
  float* out;
  int o_s0, o_s1;
  __device__ void prepare(int, int) const {}
  // neighbouring threads go down a column where the column is contiguous
  __device__ bool a_down() const { return a_s0 == 1; }
  __device__ bool v_down() const { return v_s0 == 1; }
  __device__ bool out_down() const { return o_s0 == 1; }
  __device__ const float* a_at(int l, int c) const {
    return a + (long long)l * a_s0 + (long long)c * a_s1;
  }
  __device__ const float* v_at(int l, int c) const {
    return v + (long long)l * v_s0 + (long long)c * v_s1;
  }
  __device__ void store(int l, int c, float x) const {
    out[(long long)l * o_s0 + (long long)c * o_s1] = x;
  }
};

// The single-pass HALS iteration's W half for the rows [r0, r0 + cols) of
// W (m, k) (V = W^T, column c is row r0 + c): A = the (A) stage's nsplit
// column-chunk partials of X round(H)^T, slice z at part + z * slice (rows
// from r0, row-major), added in order from 0 by `prepare` into the block's
// rows of the output, where the sweeps read them until V overwrites them.
struct RowsFrame {
  const float* w;
  const float* part;
  long long slice;
  int nsplit, k, r0;
  float* out;
  // out's rows [c0, c0 + ncol) = the partials' sums; every thread calls it.
  // No store inside the loop over slices, so its loads can all be in flight.
  __device__ void prepare(int c0, int ncol) const {
    constexpr int U = 32;  // sums a thread keeps at once
    const long long n = (long long)ncol * k, at = (long long)c0 * k;
    for (long long i0 = threadIdx.x; i0 < n; i0 += U * kThreads) {
      float sum[U];
#pragma unroll
      for (int u = 0; u < U; ++u) sum[u] = 0.f;
#pragma unroll 2
      for (int z = 0; z < nsplit; ++z)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long i = i0 + (long long)u * kThreads;
          if (i < n) sum[u] += part[z * slice + at + i];
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = i0 + (long long)u * kThreads;
        if (i < n) out[(long long)r0 * k + at + i] = sum[u];
      }
    }
  }
  __device__ bool a_down() const { return true; }
  __device__ bool v_down() const { return true; }
  __device__ bool out_down() const { return true; }
  __device__ const float* a_at(int l, int c) const { return out + (long long)(r0 + c) * k + l; }
  __device__ const float* v_at(int l, int c) const { return w + (long long)(r0 + c) * k + l; }
  __device__ void store(int l, int c, float x) const { out[(long long)(r0 + c) * k + l] = x; }
};

// Every (l, c) of a tile of `rows` rows and C columns, one call a thread
// each: a warp down a column at a time, a lane a row, where `down`, else
// neighbouring threads on neighbouring columns.
template <int C, typename F>
__device__ __forceinline__ void for_tile(int rows, bool down, F f) {
  static_assert(kThreads % C == 0, "whole rows of the tile a pass");
  if (down) {
    for (int c = threadIdx.x / 32; c < C; c += kThreads / 32)
      for (int l = threadIdx.x % 32; l < rows; l += 32) f(l, c);
  } else {
    for (int l = threadIdx.x / C; l < rows; l += kThreads / C) f(l, threadIdx.x % C);
  }
}

// nsweeps sweeps over the columns [blockIdx.x * C, + C) of V (cols in all)
// against the row-major Gram g (k, k).
template <class P, class Frame>
__global__ void __launch_bounds__(kThreads)
    gs_panel_kernel(Frame f, const float* __restrict__ g, float lam, int k, int cols,
                    int nsweeps) {
  constexpr int B = P::B, C = P::C, S = P::S, NT = P::NT, NW = P::NW, LDP = P::LDP;
  extern __shared__ float4 panel_smem[];
  const int kpad = P::kpad(k), ld = P::ld(k);
  float* vs = reinterpret_cast<float*>(panel_smem);
  float* gs = vs + C * ld;
  float* as = gs + 2 * B * ld;
  float* red = as + 2 * B * LDP;
  float* gd = red + S * B * LDP;
  float* dd = gd + kpad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * C, ncol = min(C, cols - c0);

  // V's tile and G's diagonal by 4-byte copies, zero outside them
  for_tile<C>(kpad, f.v_down(), [&](int l, int c) {
    const bool in = l < k && c < ncol;
    cp_async4(vs + c * ld + l, in ? f.v_at(l, c0 + c) : g, in);
  });
  for (int l = tid; l < kpad; l += kThreads)
    cp_async4(gd + l, l < k ? g + (long long)l * (k + 1) : g, l < k);
  cp_async_commit();
  f.prepare(c0, ncol);
  __syncthreads();  // A as prepare left it, before a copy reads it

  // Panel q % panels of G (rows past k zero) and of A into buffer q & 1,
  // one cp.async group, by the CT threads that run no chain (tid >= C),
  // while the chain runs: of G, copy thread t takes row t / TPR, 16-byte
  // pieces (4-byte words where k % 4 != 0) t % TPR + TPR j; of A, the
  // elements t + CT j.
  constexpr int CT = kThreads - C, TPR = CT / B;
  static_assert(CT % B == 0, "whole rows of G's panel a pass");
  const int panels = (k + B - 1) / B, steps = nsweeps * panels;
  const bool g_vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool a_down = f.a_down();
  auto issue = [&](int q) {
    const int t = tid - C, l0 = q % panels * B, l = l0 + t / TPR;
    float* dst = gs + (q & 1) * B * ld + t / TPR * ld;
    const float* src = g + (long long)min(l, k - 1) * k;  // a row of G, read where l < k
    if (g_vec) {
      for (int c = 4 * (t % TPR); c < kpad; c += 4 * TPR)
        hop::cp_async16(dst + c, src + min(c, k - 4), l < k && c < k ? 16 : 0);
    } else {
      for (int c = t % TPR; c < kpad; c += TPR)
        cp_async4(dst + c, src + min(c, k - 1), l < k && c < k);
    }
    float* adst = as + (q & 1) * B * LDP;
    for (int i = t; i < B * C; i += CT) {
      const int r = a_down ? i % B : i / C, c = a_down ? i / B : i % C;
      const bool in = l0 + r < k && c < ncol;
      cp_async4(adst + r * LDP + c, in ? f.a_at(l0 + r, c0 + c) : g, in);
    }
    cp_async_commit();
  };
  if (steps > 0 && tid >= C) issue(0);
  cp_async_wait_all();  // V, G's diagonal and panel 0
  __syncthreads();
  for (int l = tid; l < kpad; l += kThreads) dd[l] = (gd[l] + lam) + kHalsEps;

  // (a)'s share of each warp: tile row mt, NT tiles from column tile nt0,
  // depth slice s of S
  const int s = warp / (8 / S), tw = warp % (8 / S), mt = tw / NW, nt0 = tw % NW * NT;
  const int depth8 = (k + 7) / 8, per = (depth8 + S - 1) / S;
  const int d0 = 8 * min(s * per, depth8), d1 = 8 * min((s + 1) * per, depth8);
  for (int q = 0; q < steps; ++q) {
    const int l0 = q % panels * B;
    const float* gp = gs + (q & 1) * B * ld;
    const float* ap = as + (q & 1) * B * LDP;
    cp_async_wait_all();  // this panel's copies
    __syncthreads();

    {  // (a) P = G[l0 : l0+B, :] V, slice s of k
      tc::Acc<1, NT> acc;
      tc::zero(acc);
      tc::warp_mma<1, NT, false, true, true>(acc, gp + d0, ld, vs + d0, ld, 16 * mt, 8 * nt0,
                                             d1 - d0, lane);
      float* out = red + s * B * LDP;
      tc::for_pairs(acc, 16 * mt, 8 * nt0, lane, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(out + r * LDP + c) = make_float2(v0, v1);
      });
    }
    __syncthreads();

    if (tid < C) {  // (b) the panel's B steps for column tid
      float* vcol = vs + tid * ld + l0;
      float v[B], base[B], corr[B];
#pragma unroll
      for (int r = 0; r < B; r += 4) {
        const float4 x = *reinterpret_cast<const float4*>(vcol + r);
        v[r] = x.x, v[r + 1] = x.y, v[r + 2] = x.z, v[r + 3] = x.w;
      }
#pragma unroll
      for (int r = 0; r < B; ++r) {
        float p = red[r * LDP + tid];
#pragma unroll
        for (int z = 1; z < S; ++z) p += red[z * B * LDP + r * LDP + tid];
        base[r] = fmaf(gd[l0 + r], v[r], ap[r * LDP + tid] - p);
        corr[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < B; ++r) {
        // padded rows: 0 / (lam + eps) = 0, and nothing to correct
        const float qv = (base[r] - corr[r]) / dd[l0 + r];
        const float vn = qv < 0.f ? 0.f : qv;  // max(q, 0) that keeps a NaN, as jnp.maximum
        const float delta = vn - v[r];
        v[r] = vn;
#pragma unroll
        for (int rr = r + 1; rr < B; ++rr)
          corr[rr] = fmaf(gp[rr * ld + l0 + r], delta, corr[rr]);
      }
#pragma unroll
      for (int r = 0; r < B; r += 4)
        *reinterpret_cast<float4*>(vcol + r) = make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
    } else if (q + 1 < steps) {
      // the next panel's copies, into the buffer the last panel used
      issue(q + 1);
    }
  }
  cp_async_wait_all();  // V's copies, where there was no sweep
  __syncthreads();
  for_tile<C>(kpad, f.out_down(), [&](int l, int c) {
    if (l < k && c < ncol) f.store(l, c0 + c, vs[c * ld + l]);
  });
}

// f(Panel<B, C, S>()) for rank k <= 1024: the panel height, column tile
// and splits.
template <typename F>
cudaError_t with_panel(int k, F f) {
  if (k <= 256) return f(Panel<16, 64, 4>());
  if (k <= 512) return f(Panel<16, 32, 4>());
  return f(Panel<16, 16, 8>());
}

// nsweeps sweeps over `cols` columns of the frame's V against g (k, k).
template <class Frame>
cudaError_t gs_sweeps(const Frame& f, const float* g, float lam, int k, int cols, int nsweeps,
                      cudaStream_t s) {
  if (cols <= 0) return cudaSuccess;
  return with_panel(k, [&](auto shape) {
    using P = decltype(shape);
    return launch(gs_panel_kernel<P, Frame>, dim3(ceil_div(cols, P::C)), P::smem_bytes(k), s, f,
                  g, lam, k, cols, nsweeps);
  });
}

}  // namespace
}  // namespace tpunmf
