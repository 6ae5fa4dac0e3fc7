// HALS Gauss-Seidel sweeps: nsweeps passes of the k-step rank-1 closed-form
// chain over the rows of V, in tpunmf's transposed frame.
//
// Replaces the Pallas kernels of tpunmf/ops/hals_sweep.py: gs_sweep (:232,
// pallas_call :266), bodies _gs_sweep_kernel (:41) and _gs_sweep_fori_kernel
// (:64).
//
//   for l in 0..k-1:
//     numer  = A[l, c] - G[l, :] . V[:, c] + G[l, l] V[l, c]
//     V[l, c] = max(numer / (G[l, l] + lam + eps), 0)       eps = 1e-16
//
// (the fori form of the TPU kernel and tpunmf/solvers/hals.py:54-81; the
// unrolled TPU form keeps P = G V as a running sum instead, the same k^2
// work per column).  W frame: A = (X H^T)^T, G = H H^T, V = W^T; H frame:
// A = W^T X, G = W^T W, V = H.
//
// Bound on the H100: k^2 FMA per column per sweep (2.1 GFLOP per call at
// 8192 columns, k = 128, 2 sweeps) on 3*k*M*4 bytes, but the chain is serial
// along k, so it is bound by the latency of each step's dot product and
// reduction, not by FMA throughput or HBM.  Design:
//  * Every column is independent, so one warp owns one column: lane t holds
//    V[t + 32 i, c] and A[t + 32 i, c] (i < KPT) in registers for the whole
//    call.  A step is KPT FMAs of G's row l against the lane's V, a 5-level
//    butterfly (__shfl_xor_sync), and the update by the lane that owns row l.
//    Warps run independently: no block-wide barrier inside the chain.
//  * G is read by every warp of the card: through the read-only cache
//    (__ldg), each step a coalesced row of it (64 KB in all at k = 128, so it
//    stays in L1; at k = 1024, 4 MB, in L2).  No shared memory, so any
//    k <= 1024 fits.
//  * A, V and the output take the strides of both axes, so the W frame's
//    transposed views of row-major (m, k) tensors go in without a copy.
// Built without --use_fast_math: the division stays IEEE.
#include "common.cuh"

namespace tpunmf {
namespace {

constexpr float kHalsEps = 1e-16f;  // tpunmf/ops/hals_sweep.py:38
constexpr int kWarps = kThreads / 32;

template <int KPT>
__global__ void __launch_bounds__(kThreads)
    gs_sweep_kernel(const float* __restrict__ a, int a_s0, int a_s1,
                    const float* __restrict__ g, const float* __restrict__ v, int v_s0,
                    int v_s1, float lam, int k, int cols, int nsweeps,
                    float* __restrict__ out, int o_s0, int o_s1) {
  const int lane = threadIdx.x % 32;
  const long long c = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= cols) return;  // the whole warp: no barrier follows

  float vr[KPT], ar[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int j = lane + 32 * i;
    vr[i] = j < k ? v[(long long)j * v_s0 + c * v_s1] : 0.f;
    ar[i] = j < k ? a[(long long)j * a_s0 + c * a_s1] : 0.f;
  }
  for (int sweep = 0; sweep < nsweeps; ++sweep) {
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      for (int t = 0; t < 32; ++t) {
        const int l = 32 * i + t;
        if (l >= k) break;  // uniform across the warp
        const float* grow = g + (long long)l * k;
        float dot = 0.f;
#pragma unroll
        for (int ii = 0; ii < KPT; ++ii) {
          const int j = lane + 32 * ii;
          if (j < k) dot = fmaf(__ldg(grow + j), vr[ii], dot);
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == t) {
          const float gll = __ldg(grow + l);
          const float numer = ar[i] - dot + gll * vr[i];
          const float q = numer / (gll + lam + kHalsEps);
          vr[i] = q < 0.f ? 0.f : q;  // max(q, 0) that keeps a NaN, as jnp.maximum
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int j = lane + 32 * i;
    if (j < k) out[(long long)j * o_s0 + c * o_s1] = vr[i];
  }
}

template <int KPT>
cudaError_t sweep(const float* a, int a_s0, int a_s1, const float* g, const float* v,
                  int v_s0, int v_s1, float lam, int k, int cols, int nsweeps, float* out,
                  int o_s0, int o_s1, cudaStream_t s) {
  return launch(gs_sweep_kernel<KPT>, dim3(ceil_div(cols, kWarps)), 0, s, a, a_s0, a_s1, g,
                v, v_s0, v_s1, lam, k, cols, nsweeps, out, o_s0, o_s1);
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// out = nsweeps Gauss-Seidel sweeps over the k rows of v (k, cols), given
// a (k, cols) and the row-major Gram g (k, k).  a, v and out are addressed
// as base + row * s0 + col * s1 (element strides).  k <= 1024.
int tpunmf_gs_sweep(const void* a, int a_s0, int a_s1, const void* g, const void* v,
                    int v_s0, int v_s1, float lam, int k, int cols, int nsweeps, void* out,
                    int o_s0, int o_s1, void* stream) {
  using tpunmf::sweep;
  const float* af = static_cast<const float*>(a);
  const float* gf = static_cast<const float*>(g);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 32)
    err = sweep<1>(af, a_s0, a_s1, gf, vf, v_s0, v_s1, lam, k, cols, nsweeps, of, o_s0, o_s1, s);
  else if (k <= 64)
    err = sweep<2>(af, a_s0, a_s1, gf, vf, v_s0, v_s1, lam, k, cols, nsweeps, of, o_s0, o_s1, s);
  else if (k <= 128)
    err = sweep<4>(af, a_s0, a_s1, gf, vf, v_s0, v_s1, lam, k, cols, nsweeps, of, o_s0, o_s1, s);
  else if (k <= 256)
    err = sweep<8>(af, a_s0, a_s1, gf, vf, v_s0, v_s1, lam, k, cols, nsweeps, of, o_s0, o_s1, s);
  else if (k <= 512)
    err = sweep<16>(af, a_s0, a_s1, gf, vf, v_s0, v_s1, lam, k, cols, nsweeps, of, o_s0, o_s1, s);
  else
    err = sweep<32>(af, a_s0, a_s1, gf, vf, v_s0, v_s1, lam, k, cols, nsweeps, of, o_s0, o_s1, s);
  return static_cast<int>(err);
}

}  // extern "C"
