// Fused objective passes: 0.5 * ||X - WH||_F^2, the masked KL sum, the
// masked KL sum together with the ratio X / (WH + eps), and the ratio alone.
//
// Replaces the Pallas kernels of tpunmf/ops/fused.py: _eu_obj_kernel (body
// :76, pallas_call :136, entry eu_residual_obj :233), _kl_obj_kernel (body
// :93, pallas_call :204, entry kl_obj :220), _kl_ratio_obj_kernel (body
// :106, pallas_call :175, entry kl_ratio_and_obj :253) and _kl_ratio_kernel
// (body :88, pallas_call :156, entry kl_ratio :243).  The ratio variants
// also write one f32 per cell: 4 bytes against 2k flops per cell, so they
// stay bound by the WH tiles at every rank of their callers (50-2048).
//
// Bound on the H100: one read of X (m*n elements) against 2*m*n*k FMA for
// the WH tiles.  At rank 50-128 that is k/2 = 25-64 flops per f32 X byte,
// above the card's f32 FMA ridge (~20 flop/byte at 67 TFLOP/s and 3.35 TB/s),
// so the FMA work of WH, not the read of X, bounds it (and more so for bf16
// X, and at MUR's high ranks, 1025-2048).  Design: each block forms a 64 x 64
// WH tile in registers from shared-memory tiles of W and H, staged 16 deep
// along k, so no buffer depends on the rank (never written to memory),
// applies the epilogue and sums its tile.  The TPU added into one SMEM
// scalar across its sequential grid; here each block writes one partial and
// a second kernel adds the partials in a fixed order (in double), so the
// result does not depend on block scheduling.  No float atomics.  The ratio
// alone sums nothing: one kernel, no partials.
//
// KL masking follows tpunmf/core/losses.py:20-25 exactly: the log has no eps,
// +inf is zeroed before NaN, and -x + wh is summed for every cell.  This file
// must not be built with --use_fast_math (logf, division and denormals must
// stay IEEE for that masking, and the ratio's division must be IEEE too).
#include "common.cuh"

namespace tpunmf {
namespace {

constexpr int kObjTM = 4, kObjTN = 4, kObjTile = 64;

// What a pass computes per cell: the EU or KL term summed into a partial,
// the KL term and the ratio, or the ratio alone.
enum class Pass { kEu, kKl, kKlRatio, kRatio };

// ratio[cell] = x / (wh + eps) with the raw wh in the KL term
// (tpunmf/ops/fused.py:88-90, 113-119).
template <typename XT, Pass P>
__global__ void __launch_bounds__(kThreads)
    objective_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ h, int m, int n, int k, float eps,
                     float* __restrict__ ratio, float* __restrict__ partials) {
  constexpr bool kWritesRatio = P == Pass::kKlRatio || P == Pass::kRatio;
  constexpr bool kSums = P != Pass::kRatio;
  constexpr bool kKlTerm = P == Pass::kKl || P == Pass::kKlRatio;
  __shared__ WhStage<kObjTM, kObjTN> stage;
  __shared__ float red[kThreads];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.y * kObjTile, col0 = blockIdx.x * kObjTile;

  float s[kObjTM][kObjTN];
  wh_tile<kObjTM, kObjTN>(s, w, h, m, n, k, row0, col0, stage);

  float sum = 0.f;
#pragma unroll
  for (int a = 0; a < kObjTM; ++a) {
#pragma unroll
    for (int b = 0; b < kObjTN; ++b) {
      const int gr = row0 + ty + 16 * a, gc = col0 + tx + 16 * b;
      if (gr < m && gc < n) {
        const long long cell = (long long)gr * n + gc;
        const float xv = to_f32(x[cell]);
        const float wh = s[a][b];
        if constexpr (kWritesRatio) ratio[cell] = xv / (wh + eps);
        if constexpr (kKlTerm) {
          sum += kl_term(xv, wh);
        } else if constexpr (kSums) {
          const float d = xv - wh;
          sum += d * d;
        }
      }
    }
  }
  if constexpr (kSums) {
    red[tid] = sum;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride /= 2) {
      if (tid < stride) red[tid] += red[tid + stride];
      __syncthreads();
    }
    if (tid == 0) partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = red[0];
  }
}

// out[0] = scale * sum(partials), summed in double in a fixed order.
__global__ void __launch_bounds__(kThreads)
    reduce_partials(const float* __restrict__ partials, int count, float scale,
                    float* __restrict__ out) {
  __shared__ double red[kThreads];
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < count; i += kThreads) s += partials[i];
  red[tid] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) out[0] = (float)(scale * red[0]);
}

template <typename XT, Pass P>
cudaError_t launch_pass(const void* x, const float* w, const float* h, int m, int n, int k,
                        float eps, float* ratio, float* partials, float* out,
                        cudaStream_t stream) {
  const dim3 grid((n + kObjTile - 1) / kObjTile, (m + kObjTile - 1) / kObjTile);
  objective_kernel<XT, P><<<grid, kThreads, 0, stream>>>(static_cast<const XT*>(x), w, h,
                                                          m, n, k, eps, ratio, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == Pass::kRatio) return err;
  return reduce_partials_into(partials, grid.x * grid.y, P == Pass::kEu ? 0.5f : 1.f, out,
                              stream);
}

// The pass on X of either storage type; the C entries below call this.
template <Pass P>
int run_pass(const void* x, int x_is_bf16, const void* w, const void* h, int m, int n, int k,
             float eps, void* ratio, void* partials, void* out, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  float* r = static_cast<float*>(ratio);
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_is_bf16
                        ? launch_pass<__nv_bfloat16, P>(x, wf, hf, m, n, k, eps, r, p, o, s)
                        : launch_pass<float, P>(x, wf, hf, m, n, k, eps, r, p, o, s);
  return static_cast<int>(err);
}

}  // namespace

cudaError_t reduce_partials_into(const float* partials, int count, float scale, float* out,
                                 cudaStream_t stream) {
  reduce_partials<<<1, kThreads, 0, stream>>>(partials, count, scale, out);
  return cudaGetLastError();
}

}  // namespace tpunmf

extern "C" {

int tpunmf_objective_blocks(int m, int n) {
  using tpunmf::kObjTile;
  return ((m + kObjTile - 1) / kObjTile) * ((n + kObjTile - 1) / kObjTile);
}

// 0.5*||X - WH||^2 (is_kl = 0) or the masked KL sum (is_kl = 1) into out[0].
// partials holds tpunmf_objective_blocks(m, n) floats of scratch.
int tpunmf_objective(const void* x, int x_is_bf16, const void* w, const void* h, int m,
                     int n, int k, int is_kl, void* partials, void* out, void* stream) {
  using tpunmf::Pass;
  return is_kl ? tpunmf::run_pass<Pass::kKl>(x, x_is_bf16, w, h, m, n, k, 0.f, nullptr,
                                             partials, out, stream)
               : tpunmf::run_pass<Pass::kEu>(x, x_is_bf16, w, h, m, n, k, 0.f, nullptr,
                                             partials, out, stream);
}

// ratio (m x n f32) = X / (WH + eps) and the masked KL sum into out[0], from
// one pass; partials as for tpunmf_objective.
int tpunmf_kl_ratio_obj(const void* x, int x_is_bf16, const void* w, const void* h, int m,
                        int n, int k, float eps, void* ratio, void* partials, void* out,
                        void* stream) {
  return tpunmf::run_pass<tpunmf::Pass::kKlRatio>(x, x_is_bf16, w, h, m, n, k, eps, ratio,
                                                  partials, out, stream);
}

// ratio (m x n f32) = X / (WH + eps) alone: one kernel, no scratch.
int tpunmf_kl_ratio(const void* x, int x_is_bf16, const void* w, const void* h, int m, int n,
                    int k, float eps, void* ratio, void* stream) {
  return tpunmf::run_pass<tpunmf::Pass::kRatio>(x, x_is_bf16, w, h, m, n, k, eps, ratio,
                                                nullptr, nullptr, stream);
}

}  // extern "C"
